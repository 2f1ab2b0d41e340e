"""Factorization Machine (Rendle, ICDM'10) over giant sparse embedding tables.

Port of ``repro.models.recsys``.  All per-field tables are one
concatenated table with static per-field row offsets, so a batch of
(B, F) ids is a single gather; ``embedding_bag`` is the multi-hot
(ragged) reduction.  The FM pairwise term uses the O(nk) sum-square
identity

    sum_{i<j} <v_i, v_j> = 1/2 * sum_k [ (sum_i v_ik)^2 - sum_i v_ik^2 ]

in plain PyTorch (:func:`fm_interaction`) or through kernel B4
(``forward(..., use_kernel=True)``).  The gather, the linear sum and the
retrieval GEMV are plain torch ops, as the reference leaves them to XLA.

Out-of-range ids give what the reference's ``jnp.take`` gives (its
default "fill" mode): a row id in ``[-rows, 0)`` wraps from the end, any
other id outside ``[0, rows)`` gives a row of NaN.  ``torch`` indexing
would raise instead, and on the card a device-side assert would end the
context, so :func:`take_rows` clamps the index and fills the row.

The reference's ``constrain`` (sharding hints) has no counterpart until
the multi-device slice: one H100 holds the whole ``fm`` table.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.fm_interaction import ops as fm_ops
from repro_torch.nn.core import as_dtype


def field_offsets(cfg: RecsysConfig) -> np.ndarray:
    """Static row offset of each field inside the concatenated table.

    int32 covers tables up to 2.1B rows.
    """
    sizes = np.asarray(cfg.vocab_sizes, dtype=np.int64)
    assert sizes.shape[0] == cfg.n_sparse, (sizes.shape, cfg.n_sparse)
    assert sizes.sum() < 2**31, "int32 row index overflow"
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)


def padded_rows(cfg: RecsysConfig, multiple: int = 1024) -> int:
    """Table rows rounded up so row-sharding divides any production mesh
    (512 chips); the pad rows are dead weight never indexed."""
    return -(-cfg.total_rows // multiple) * multiple


def init(seed: int, cfg: RecsysConfig, device="cuda"):
    """Random params from ``seed``, drawn on ``device`` with a generator
    of that device (the ``fm`` table is 3.36 GiB: drawing it on the host
    and copying would cost seconds and host memory).

    The reference's distribution: factor rows ``normal / sqrt(K)`` cast
    to ``cfg.param_dtype``, then ``x 0.01``; linear rows and the bias
    zero.  The numbers differ from the JAX init of the same seed; parity
    tests carry JAX params across with ``bridge.params_from_jax``.
    """
    dev = resolve_device(device)
    rows = padded_rows(cfg)
    pd = as_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    table = torch.randn((rows, cfg.embed_dim), generator=gen, device=dev,
                        dtype=torch.float32)
    table.mul_(1.0 / np.sqrt(cfg.embed_dim))
    table = table.to(pd).mul_(0.01)
    return {
        "tables": {"rows": table},
        "linear": {"rows": torch.zeros((rows, 1), dtype=pd, device=dev)},
        "bias": torch.zeros((), dtype=pd, device=dev),
    }


# ---------------------------------------------------------------------------
# embedding substrate
# ---------------------------------------------------------------------------

def take_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, rows, axis=0)`` in its default "fill" mode:
    ``rows`` (any shape, integer) -> ``rows.shape + table.shape[1:]``; an
    id in ``[-n, 0)`` wraps, any id outside ``[-n, n)`` gives NaN."""
    n = table.shape[0]
    rows = rows.long()
    valid = (rows >= -n) & (rows < n)
    idx = torch.where(rows < 0, rows + n, rows)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    out = table[idx]
    if bool(valid.all()):
        return out
    fill = valid.reshape(valid.shape + (1,) * (out.dim() - valid.dim()))
    return out.masked_fill(~fill, math.nan)


def _flat_rows(cfg: RecsysConfig, ids: torch.Tensor,
               fields=slice(None)) -> torch.Tensor:
    offs = torch.from_numpy(field_offsets(cfg)[fields]).to(ids.device)
    return ids.to(torch.int32) + offs


def lookup(params, cfg: RecsysConfig, ids):
    """ids: (B, F) per-field local ids -> (v (B, F, K), w (B, F))."""
    flat = _flat_rows(cfg, ids)
    v = take_rows(params["tables"]["rows"], flat)            # (B, F, K)
    w = take_rows(params["linear"]["rows"], flat)[..., 0]
    return v, w


def embedding_bag(table, indices, segment_ids, n_segments: int,
                  mode: str = "sum", weights=None):
    """EmbeddingBag: ragged multi-hot lookup + per-bag reduction.

    table: (rows, K); indices: (nnz,) row ids; segment_ids: (nnz,) bag id
    of each index (sorted or not); returns (n_segments, K).  Segment ids
    outside ``[0, n_segments)`` are dropped, as ``jax.ops.segment_sum``
    drops them; an empty bag gives 0 in every mode.
    """
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
    g = take_rows(table, indices)                            # (nnz, K)
    if weights is not None:
        g = g * weights[:, None].to(g.dtype)
    seg = segment_ids.long()
    keep = (seg >= 0) & (seg < n_segments)
    if not bool(keep.all()):
        g, seg = g[keep], seg[keep]
    shape = (n_segments,) + tuple(g.shape[1:])
    if mode == "max":
        m = torch.full(shape, -math.inf, dtype=g.dtype, device=g.device)
        m.scatter_reduce_(0, seg[:, None].expand_as(g), g, "amax")
        return torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.zeros(shape, dtype=g.dtype, device=g.device).index_add_(
        0, seg, g)
    if mode == "sum":
        return s
    cnt = torch.zeros((n_segments,), dtype=g.dtype, device=g.device)
    cnt.index_add_(0, seg, torch.ones_like(seg, dtype=g.dtype))
    return s / cnt.clamp_min(1.0)[:, None]


# ---------------------------------------------------------------------------
# FM forward
# ---------------------------------------------------------------------------

def fm_interaction(v: torch.Tensor) -> torch.Tensor:
    """Sum-square strength reduction. v: (..., F, K) -> (...,) scalar term."""
    sum_v = v.sum(-2)                                        # (..., K)
    sum_sq = v.square().sum(-2)                              # (..., K)
    return 0.5 * (sum_v.square() - sum_sq).sum(-1)


def forward(params, cfg: RecsysConfig, ids, *, use_kernel: bool = False):
    """ids: (B, F) -> logits (B,) fp32.  ``use_kernel`` takes the pairwise
    term through kernel B4 (one launch per call on the card)."""
    v, w = lookup(params, cfg, ids)
    if use_kernel:
        inter = fm_ops.fm_interaction(v)
    else:
        inter = fm_interaction(v.float())
    linear = w.float().sum(-1)
    return linear + inter + params["bias"].float()


def loss_fn(params, cfg: RecsysConfig, batch, **kw):
    """Binary logistic loss. batch: {ids (B, F), y (B,) in {0,1}}."""
    logits = forward(params, cfg, batch["ids"], **kw)
    y = batch["y"].float()
    # numerically stable BCE-with-logits
    loss = torch.mean(torch.clamp_min(logits, 0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))
    acc = torch.mean(((logits > 0) == (y > 0.5)).float())
    return loss, {"accuracy": acc}


# ---------------------------------------------------------------------------
# retrieval: 1 query x N candidates
# ---------------------------------------------------------------------------

def retrieval_score(params, cfg: RecsysConfig, user_ids, cand_ids):
    """Score one query against a large candidate set, as one GEMV.

    user_ids: (F-1,) the query's field ids; cand_ids: (N,) candidate ids
    in the LAST field's vocabulary (the "item" field).  The FM score
    decomposes as

        s(u, c) = const(u) + w_c + <sum_f v_f(u), v_c>

    so scoring N candidates is a (N, K) @ (K,) matvec — never a loop.
    """
    u_rows = _flat_rows(cfg, user_ids, slice(None, -1))       # user fields
    vu = take_rows(params["tables"]["rows"], u_rows)          # (F-1, K)
    wu = take_rows(params["linear"]["rows"], u_rows)[..., 0]

    vu32 = vu.float()
    q = vu32.sum(0)                                           # (K,) query
    const_u = (wu.float().sum() + fm_interaction(vu32)
               + params["bias"].float())

    c_rows = _flat_rows(cfg, cand_ids, slice(-1, None))
    vc = take_rows(params["tables"]["rows"], c_rows)          # (N, K)
    wc = take_rows(params["linear"]["rows"], c_rows)[..., 0]
    return vc.float() @ q + wc.float() + const_u
