"""equiformer-v2 [gnn] — SO(2)-eSCN equivariant graph attention.
[arXiv:2306.12059; unverified]

n_layers=12 d_hidden=128 l_max=6 m_max=2 n_heads=8.  Node features are
real-SH irreps (N, (l_max+1)^2 = 49, 128); the eSCN trick reduces the
SO(3) tensor product to per-|m| SO(2) mixes (O(L^3) instead of O(L^6)).
"""

from repro_torch.configs.base import ArchSpec, GNN_SHAPES, GNNConfig

MODEL = GNNConfig(
    name="equiformer-v2",
    kind="equiformer_v2",
    n_layers=12,
    d_hidden=128,
    n_classes=1,                 # energy regression head (invariant)
    l_max=6,
    m_max=2,
    n_heads=8,
    activation="silu",
)

ARCH = ArchSpec(
    arch_id="equiformer-v2",
    family="gnn",
    model=MODEL,
    shapes=dict(GNN_SHAPES),
    source="arXiv:2306.12059; unverified",
    notes="eSCN: rotate to edge frame (Wigner J-matrix fast path), SO(2) "
          "mix per |m| <= 2, rotate back; edge-chunked scan for the "
          "61.8M-edge ogb_products cell.",
)
