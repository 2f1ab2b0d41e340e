"""jedinet-30p — the paper's own model (JEDI-net, 30-particle dataset).

JEDI-net [5] (arXiv:1908.05318) as accelerated by LL-GNN: N_o=30, P=16,
3-layer MLPs of width 20 (the J1/J2 baseline size from Table 2).  The
co-design search (repro/core/codesign.py) re-balances these sizes into the
J3..J5 variants.
"""

from repro_torch.configs.base import ArchSpec, JEDI_SHAPES
from repro_torch.core.interaction_net import JediNetConfig

MODEL = JediNetConfig(
    n_objects=30,
    n_features=16,
    d_e=8,
    d_o=24,
    n_targets=5,
    fr_hidden=(20, 20, 20),
    fo_hidden=(20, 20, 20),
    phi_hidden=(20, 20, 20),
)

ARCH = ArchSpec(
    arch_id="jedinet-30p",
    family="jedi",
    model=MODEL,
    shapes=dict(JEDI_SHAPES),
    source="arXiv:1908.05318 + this paper Table 2",
    notes="The paper's end-to-end application; 870 edges.",
)
