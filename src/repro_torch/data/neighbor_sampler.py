"""Layered uniform neighbor sampler (GraphSAGE-style) for minibatch_lg.

A copy of ``repro.data.neighbor_sampler`` (pure numpy): the same seed gives
byte-identical arrays.

A REAL sampler, not a stub: builds a CSR adjacency once (numpy), then per
batch samples `fanout = (15, 10)`-hop neighborhoods around seed nodes and
emits a *fixed-shape padded subgraph* so the jitted train step never
recompiles:

    nodes      : (max_nodes,) global ids (padded with -1)
    x          : (max_nodes, F) gathered features (0 for pads)
    senders/receivers : (max_edges,) LOCAL indices into `nodes`
    edge_mask  : (max_edges,) bool
    seed_mask  : (max_nodes,) bool — loss is computed on seeds only
    y          : (max_nodes,) labels (-1 for pads)

Static shapes are the TPU-native answer to data-dependent subgraph sizes —
the same "structured over irregular" trade the paper makes for its
fixed-pattern adjacency (DESIGN.md §Adaptation).
"""

from __future__ import annotations

import numpy as np


class CSRGraph:
    def __init__(self, n_nodes: int, senders: np.ndarray,
                 receivers: np.ndarray):
        # CSR over OUT-edges of each node: neighbors(n) = senders' targets.
        order = np.argsort(senders, kind="stable")
        self.dst_sorted = receivers[order].astype(np.int32)
        counts = np.bincount(senders, minlength=n_nodes)
        self.indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n_nodes = n_nodes

    def sample_neighbors(self, rng, nodes: np.ndarray, k: int):
        """Uniform-with-replacement k neighbors per node; isolated -> self."""
        start = self.indptr[nodes]
        deg = self.indptr[nodes + 1] - start
        pick = (rng.rand(nodes.shape[0], k) * np.maximum(deg, 1)[:, None])
        idx = start[:, None] + pick.astype(np.int64)
        nb = self.dst_sorted[np.minimum(idx, len(self.dst_sorted) - 1)]
        nb = np.where(deg[:, None] > 0, nb, nodes[:, None])   # self-loop pad
        return nb.astype(np.int32)


def sample_subgraph(csr: CSRGraph, rng, seeds: np.ndarray,
                    fanout: tuple, x: np.ndarray, y: np.ndarray,
                    max_nodes: int, max_edges: int):
    """One padded fixed-shape subgraph batch around `seeds`."""
    frontier = seeds.astype(np.int32)
    all_src, all_dst = [], []
    layers = [frontier]
    for k in fanout:
        nb = csr.sample_neighbors(rng, frontier, k)          # (n, k)
        src = nb.reshape(-1)
        dst = np.repeat(frontier, k)
        all_src.append(src)
        all_dst.append(dst)
        frontier = np.unique(src)
        layers.append(frontier)

    nodes = np.unique(np.concatenate(layers))
    src = np.concatenate(all_src)
    dst = np.concatenate(all_dst)

    # global -> local relabel
    local = {g: i for i, g in enumerate(nodes)}
    lsrc = np.fromiter((local[g] for g in src), np.int32, len(src))
    ldst = np.fromiter((local[g] for g in dst), np.int32, len(dst))

    n, e = len(nodes), len(lsrc)
    if n > max_nodes or e > max_edges:
        raise ValueError(f"subgraph ({n}, {e}) exceeds static budget "
                         f"({max_nodes}, {max_edges})")

    out = {
        "x": np.zeros((max_nodes, x.shape[1]), np.float32),
        "senders": np.zeros((max_edges,), np.int32),
        "receivers": np.full((max_edges,), max_nodes - 1, np.int32),
        "edge_mask": np.zeros((max_edges,), bool),
        "seed_mask": np.zeros((max_nodes,), bool),
        "y": np.full((max_nodes,), -1, np.int32),
        "n_nodes": np.int32(n),
    }
    out["x"][:n] = x[nodes]
    out["senders"][:e] = lsrc
    out["receivers"][:e] = ldst
    out["edge_mask"][:e] = True
    seed_local = np.fromiter((local[g] for g in seeds), np.int32, len(seeds))
    out["seed_mask"][seed_local] = True
    out["y"][:n] = y[nodes]
    return out


def static_budget(batch_nodes: int, fanout: tuple) -> tuple:
    """(max_nodes, max_edges) worst case for a fanout tree + slack."""
    nodes = batch_nodes
    total_nodes = batch_nodes
    total_edges = 0
    frontier = batch_nodes
    for k in fanout:
        total_edges += frontier * k
        frontier = frontier * k
        total_nodes += frontier
    # unique() usually shrinks this a lot; keep the worst case for safety.
    return total_nodes, total_edges


def minibatch_stream(seed: int, graph: dict, batch_nodes: int,
                     fanout: tuple, max_nodes: int | None = None,
                     max_edges: int | None = None):
    """Infinite iterator of padded subgraph batches from a full graph."""
    n = graph["x"].shape[0]
    csr = CSRGraph(n, graph["senders"], graph["receivers"])
    mn, me = static_budget(batch_nodes, fanout)
    mn, me = max_nodes or mn, max_edges or me
    rng = np.random.RandomState(seed)
    while True:
        seeds = rng.choice(n, batch_nodes, replace=False)
        yield sample_subgraph(csr, rng, seeds, fanout, graph["x"],
                              graph["y"], mn, me)
