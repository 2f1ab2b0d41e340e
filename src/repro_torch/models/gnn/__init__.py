"""The GNN zoo (counterpart of ``repro.models.gnn``): GCN, PNA,
MeshGraphNet and EquiformerV2 over the segment-op substrate."""

from repro_torch.models.gnn import (equiformer_v2, gcn, meshgraphnet, pna,
                                    segment_ops)

GNN_MODULES = {
    "gcn": gcn,
    "pna": pna,
    "meshgraphnet": meshgraphnet,
    "equiformer_v2": equiformer_v2,
}

__all__ = ["GNN_MODULES", "segment_ops", "gcn", "pna", "meshgraphnet",
           "equiformer_v2"]
