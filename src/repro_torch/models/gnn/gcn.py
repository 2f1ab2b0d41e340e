"""GCN (Kipf & Welling, arXiv:1609.02907) with symmetric normalization.

Port of ``repro.models.gnn.gcn``.

h' = act( D^-1/2 (A+I) D^-1/2 H W )

Implemented over the segment-op substrate.  One production detail matters
for the large full-graph cells: *aggregate after projection* — H W first
(shrinks 1433 -> 16 features for cora, 100 -> 16 for ogb-products), then the
edge gather/scatter runs on the narrow representation, cutting edge traffic
by d_in/d_hidden (~90x for cora).  The sym-norm edge weight
1/sqrt(deg_i deg_j) is computed from degrees on the fly — the adjacency is
never materialized as a matrix.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import segment_ops as seg
from repro_torch.nn import core as nn
from repro_torch.parallel.sharding import constrain


def init(key_or_seed, cfg: GNNConfig, d_in: int, n_out: int, *,
         device="cuda"):
    """Params on ``device``: a ``prng`` key replays the reference's init
    at that key; an int or a ``torch.Generator`` draws torch's own."""
    dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [n_out]
    keys = nn.split_source(key_or_seed, len(dims) - 1)
    layers = [nn.dense_init(k, a, b, scale="lecun", device=device)
              for k, a, b in zip(keys, dims[:-1], dims[1:])]
    return {"gnn_layers": layers}


def apply(params, cfg: GNNConfig, graph):
    """graph: dict(x (N,F), senders (E,), receivers (E,)) -> (N, n_out)."""
    x = graph["x"]
    s, r = graph["senders"], graph["receivers"]
    n = x.shape[0]
    act = nn.ACTIVATIONS[cfg.activation]

    # self-loops are modeled by adding the node's own (normalized) term.
    deg = seg.degrees(r, n) + 1.0                       # in-degree + self
    inv_sqrt = torch.rsqrt(deg)
    w_edge = (seg.gather(inv_sqrt, s) * seg.gather(inv_sqrt, r))[:, None]
    self_w = (inv_sqrt * inv_sqrt)[:, None]

    h = x
    for i, lp in enumerate(params["gnn_layers"]):
        h = nn.dense_apply(lp, h)                       # project first
        h = constrain(h, "nodes", None)
        msgs = seg.gather(h, s) * w_edge.to(h.dtype)
        msgs = constrain(msgs, "edges", None)
        agg = seg.scatter_sum(msgs, r, n) + h * self_w.to(h.dtype)
        h = act(agg) if i < len(params["gnn_layers"]) - 1 else agg
        h = constrain(h, "nodes", None)
    return h
