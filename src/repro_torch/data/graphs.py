"""Synthetic graph generators for the four GNN shape cells.

A copy of ``repro.data.graphs`` (pure numpy): the same seed gives
byte-identical arrays.

Graph dict convention (shared with every GNN model):
    x: (N, F) node features; senders/receivers: (E,) int32 edge index;
    pos: (N, 3) optional coordinates; y: labels.

Generators are numpy-only (the device never sees graph construction) and
deterministic given a seed.  The planted community structure gives GCN a
learnable signal on the full-graph cells.
"""

from __future__ import annotations

import numpy as np


def community_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int,
                    n_classes: int = 7, homophily: float = 0.8):
    """Cora-like: class-conditioned features + mostly intra-class edges."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, n_nodes).astype(np.int32)
    proto = rng.normal(0, 1, (n_classes, d_feat)).astype(np.float32)
    x = proto[y] + rng.normal(0, 2.0, (n_nodes, d_feat)).astype(np.float32)

    intra = rng.rand(n_edges) < homophily
    src = rng.randint(0, n_nodes, n_edges)
    dst = np.empty(n_edges, np.int64)
    # intra-class edges: resample dst from same-class nodes via sorted trick
    order = np.argsort(y, kind="stable")
    class_start = np.searchsorted(y[order], np.arange(n_classes))
    class_cnt = np.bincount(y, minlength=n_classes)
    same = class_start[y[src]] + (rng.rand(n_edges)
                                  * class_cnt[y[src]]).astype(np.int64)
    dst[intra] = order[same[intra]]
    dst[~intra] = rng.randint(0, n_nodes, (~intra).sum())
    return {
        "x": x,
        "senders": src.astype(np.int32),
        "receivers": dst.astype(np.int32),
        "y": y,
    }


def mesh_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int):
    """Positioned point cloud with k-NN-ish local edges (meshgraphnet)."""
    rng = np.random.RandomState(seed)
    pos = rng.normal(0, 1, (n_nodes, 3)).astype(np.float32)
    x = rng.normal(0, 1, (n_nodes, d_feat)).astype(np.float32)
    # local edges: random pairs biased to nearby indices (cheap locality)
    src = rng.randint(0, n_nodes, n_edges)
    off = rng.randint(1, max(2, n_nodes // 100), n_edges)
    dst = (src + off) % n_nodes
    # target: local smoothing field (learnable for message passing)
    y = np.tanh(pos @ rng.normal(0, 1, (3, 3))).astype(np.float32)
    return {
        "x": x, "pos": pos,
        "senders": src.astype(np.int32),
        "receivers": dst.astype(np.int32),
        "y": y,
    }


def molecule_batch(seed: int, batch: int, n_nodes: int, n_edges: int,
                   d_feat: int):
    """Batched small molecules: (B, N, F) features, (B, E) edges, per-graph y."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (batch, n_nodes, d_feat)).astype(np.float32)
    pos = rng.normal(0, 1, (batch, n_nodes, 3)).astype(np.float32)
    senders = rng.randint(0, n_nodes, (batch, n_edges)).astype(np.int32)
    receivers = rng.randint(0, n_nodes, (batch, n_edges)).astype(np.int32)
    y = (x.mean((1, 2)) > 0).astype(np.int32)      # planted global label
    return {"x": x, "pos": pos, "senders": senders, "receivers": receivers,
            "y": y}
