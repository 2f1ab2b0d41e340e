"""jedinet-50p — the paper's own model (JEDI-net, 50-particle dataset).

N_o=50, P=16, 3-layer MLPs of width 50 (the U1/U2/U3 baseline from
Table 2); 2450 edges.
"""

from repro_torch.configs.base import ArchSpec, JEDI_SHAPES
from repro_torch.core.interaction_net import JediNetConfig

MODEL = JediNetConfig(
    n_objects=50,
    n_features=16,
    d_e=8,
    d_o=24,
    n_targets=5,
    fr_hidden=(50, 50, 50),
    fo_hidden=(50, 50, 50),
    phi_hidden=(50, 50, 50),
)

ARCH = ArchSpec(
    arch_id="jedinet-50p",
    family="jedi",
    model=MODEL,
    shapes=dict(JEDI_SHAPES),
    source="arXiv:1908.05318 + this paper Table 2",
    notes="Large variant: 2450 edges; the U4/U5 co-designed configs "
          "come from the DSE.",
)
