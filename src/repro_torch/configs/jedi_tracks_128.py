"""jedinet-tracks-128 — large-graph regime: 128 tracks per event.

The paper's JEDI-net tops out at N_o=50; real-time graph building on
FPGAs (Neu et al., arXiv:2307.07289) and JEDI-linear (Que et al.,
arXiv:2508.15468) target O(100) tracks per event.  16,256 edges per
event.  In the port's CUDA kernel this is the widest case: f_R width
128, about 120 KB of fp32 weights in shared memory, and a sender tile
smaller than N_o.
"""

from repro_torch.configs.base import ArchSpec, JEDI_SHAPES
from repro_torch.core.interaction_net import JediNetConfig

MODEL = JediNetConfig(
    n_objects=128,
    n_features=16,
    d_e=8,
    d_o=24,
    n_targets=5,
    fr_hidden=(128, 128),
    fo_hidden=(64, 64),
    phi_hidden=(32, 32),
)

ARCH = ArchSpec(
    arch_id="jedinet-tracks-128",
    family="jedi",
    model=MODEL,
    shapes=dict(JEDI_SHAPES),
    source="arXiv:2307.07289 (track-graph regime) + this repo",
    notes="Large-graph variant: 16,256 edges; f_R width 128 runs the "
          "team layouts of B1 (sender tile 48), B2 and B3.",
)
