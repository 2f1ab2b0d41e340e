"""Fully-connected interaction-graph structure and its strength reduction.

A copy of ``repro.core.adjacency`` (pure numpy): the port imports nothing of the
JAX package, and the same seed must give byte-identical arrays.

The LL-GNN paper's first contribution (Sec. 3.1) is a *code transformation
with strength reduction* for the three matrix-matrix multiplications of the
interaction network:

    MMM1:  B1 = I @ Rr        (receiver features per edge)
    MMM2:  B2 = I @ Rs        (sender   features per edge)
    MMM3:  Ebar = E @ Rr^T    (sum of incoming edge messages per node)

For a fully connected graph with N_o nodes, Rr and Rs are binary (N_o, N_E)
matrices with one-hot columns and a *fixed, static* pattern:

    edge e = i*(N_o-1) + k   has   receiver(e) = i
                                   sender(e)   = k if k < i else k + 1

so MMM1/MMM2 degenerate into pure loads/stores (a broadcast and a static
gather) and MMM3 degenerates into a reshape + sum over the k axis — no
multiplications, no adjacency matrix in memory, no irregular access.

TPU adaptation (see DESIGN.md): the FPGA design fuses the static pattern
into HLS loop indices; on TPU we fuse it into *array layout*.  Edges are laid
out receiver-major so that

    B1   = broadcast of node features over the k axis       (a reshape)
    B2   = one static gather with a compile-time index map   (XLA constant)
    Ebar = reshape (N_o, N_o-1, D_e) + sum over axis 1       (a reduction)

which is exactly the paper's "only loads/stores + 1/N_o of the additions",
expressed in a form the XLA/Mosaic compilers turn into contiguous VMEM
traffic.  The dense matrices are retained only as the paper-[5] baseline and
as the oracle for tests.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def edge_index_maps(n_obj: int) -> tuple[np.ndarray, np.ndarray]:
    """Static (receivers, senders) index vectors for the FC interaction graph.

    Edge ordering is receiver-major: e = i*(n_obj-1) + k, matching
    Algorithm 1 of the paper.  Both arrays have shape (n_obj*(n_obj-1),).
    """
    if n_obj < 2:
        raise ValueError("interaction graph needs at least 2 objects")
    i = np.repeat(np.arange(n_obj), n_obj - 1)
    k = np.tile(np.arange(n_obj - 1), n_obj)
    senders = np.where(k < i, k, k + 1)
    return i.astype(np.int32), senders.astype(np.int32)


@lru_cache(maxsize=None)
def sender_index_matrix(n_obj: int) -> np.ndarray:
    """(n_obj, n_obj-1) matrix of sender indices, row i = senders of receiver i.

    Row i is [0, 1, ..., i-1, i+1, ..., n_obj-1]: the paper's
    ``index = (k < i) ? k : k + 1`` from Algorithm 1.
    """
    _, senders = edge_index_maps(n_obj)
    return senders.reshape(n_obj, n_obj - 1)


@lru_cache(maxsize=None)
def dense_relation_matrices(n_obj: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense one-hot Rr, Rs of shape (n_obj, n_E) — the paper-[5] baseline.

    Only used by the unoptimized reference path and the tests; the
    strength-reduced path never materializes these.
    """
    receivers, senders = edge_index_maps(n_obj)
    n_e = n_obj * (n_obj - 1)
    rr = np.zeros((n_obj, n_e), dtype=np.float32)
    rs = np.zeros((n_obj, n_e), dtype=np.float32)
    rr[receivers, np.arange(n_e)] = 1.0
    rs[senders, np.arange(n_e)] = 1.0
    return rr, rs


def mmm_op_counts(n_obj: int, n_feat: int, d_e: int) -> dict:
    """Multiply/add/iteration counts for MMM1/2/3, baseline vs strength-reduced.

    Reproduces Fig. 8 of the paper analytically (benchmarked in
    ``benchmarks/bench_ops_reduction.py``):

    * baseline MMM1 (I @ Rr): P x N_o x N_E mults, P x (N_o-1) x N_E adds
    * baseline MMM3 (E @ Rr^T): D_e x N_E x N_o mults, D_e x (N_E-1) x N_o adds
    * strength-reduced MMM1/2: zero mults / zero adds (loads+stores only)
    * strength-reduced MMM3:  zero mults, D_e x N_E adds
    * iterations: N_o x (N_o-1) -> (N_o - 1) per the 1-hot reduction
    """
    n_e = n_obj * (n_obj - 1)
    return {
        "n_edges": n_e,
        "mmm12_baseline_mults": n_feat * n_obj * n_e,
        "mmm12_baseline_adds": n_feat * (n_obj - 1) * n_e,
        "mmm12_sr_mults": 0,
        "mmm12_sr_adds": 0,
        "mmm3_baseline_mults": d_e * n_e * n_obj,
        "mmm3_baseline_adds": d_e * (n_e - 1) * n_obj,
        "mmm3_sr_mults": 0,
        "mmm3_sr_adds": d_e * n_e,
        "iterations_baseline": n_obj * (n_obj - 1),
        "iterations_sr": n_obj - 1,
    }
