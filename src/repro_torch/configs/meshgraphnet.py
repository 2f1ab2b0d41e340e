"""meshgraphnet [gnn] — encode-process-decode mesh simulator.
[arXiv:2010.03409; unverified]

n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2, edge features from
relative positions.  Output is a per-node regression (3-d velocity update),
so n_classes here is the regression dim.
"""

from repro_torch.configs.base import ArchSpec, GNN_SHAPES, GNNConfig

MODEL = GNNConfig(
    name="meshgraphnet",
    kind="meshgraphnet",
    n_layers=15,
    d_hidden=128,
    n_classes=3,                 # velocity regression
    aggregators=("sum",),
    mlp_layers=2,
    activation="relu",
)

ARCH = ArchSpec(
    arch_id="meshgraphnet",
    family="gnn",
    model=MODEL,
    shapes=dict(GNN_SHAPES),
    source="arXiv:2010.03409; unverified",
    notes="15 message-passing blocks, residual + LayerNorm, 2-layer MLPs.",
)
