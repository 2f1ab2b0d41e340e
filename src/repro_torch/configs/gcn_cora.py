"""gcn-cora [gnn] — 2-layer GCN (Kipf & Welling). [arXiv:1609.02907; paper]

n_layers=2 d_hidden=16 aggregator=mean norm=sym.  The canonical citation
config: 1433-d bag-of-words features, 7 classes on the full_graph_sm
(cora-sized) cell; the same model scales to ogb_products and the sampled
minibatch_lg cell through the shared segment-op substrate.
"""

from repro_torch.configs.base import ArchSpec, GNN_SHAPES, GNNConfig

MODEL = GNNConfig(
    name="gcn-cora",
    kind="gcn",
    n_layers=2,
    d_hidden=16,
    n_classes=7,
    aggregators=("mean",),
    norm="sym",
    activation="relu",
)

ARCH = ArchSpec(
    arch_id="gcn-cora",
    family="gnn",
    model=MODEL,
    shapes=dict(GNN_SHAPES),
    source="arXiv:1609.02907; paper",
    notes="Sym-normalized SpMM via segment ops; project-then-aggregate.",
)
