"""pna [gnn] — Principal Neighbourhood Aggregation. [arXiv:2004.05718; paper]

n_layers=4 d_hidden=75, aggregators mean/max/min/std, scalers
identity/amplification/attenuation (12 aggregated views per layer).
"""

from repro_torch.configs.base import ArchSpec, GNN_SHAPES, GNNConfig

MODEL = GNNConfig(
    name="pna",
    kind="pna",
    n_layers=4,
    d_hidden=75,
    n_classes=16,
    aggregators=("mean", "max", "min", "std"),
    scalers=("identity", "amplification", "attenuation"),
    activation="relu",
)

ARCH = ArchSpec(
    arch_id="pna",
    family="gnn",
    model=MODEL,
    shapes=dict(GNN_SHAPES),
    source="arXiv:2004.05718; paper",
    notes="4 aggregators x 3 degree scalers -> 12x concat per layer.",
)
