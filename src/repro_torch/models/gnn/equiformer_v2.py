"""EquiformerV2-style equivariant graph attention via eSCN SO(2) convolutions.

Port of ``repro.models.gnn.equiformer_v2`` (arXiv:2306.12059).  Node
features are real-SH irreps (N, (l_max+1)^2, C) (sphere channels C for
every (l, m)).  Per layer:

1. edge scores from invariant (l=0) channels + distance RBF -> per-head
   segment-softmax attention over incoming edges;
2. eSCN conv: rotate source irreps into the edge frame (Wigner align-z,
   fast J-matrix path), SO(2)-mix per |m| <= m_max with complex-pair
   weights, gate by a radial MLP, rotate back;
3. aggregate messages (attention-weighted segment-sum), per-l linear
   projection, residual;
4. equivariant LayerNorm + gated FFN (SiLU on l=0; sigmoid(l=0) gates
   scaling l>0 — the gate nonlinearity).

Large graphs cannot hold every edge's messages at once: when E exceeds
``cfg.edge_chunk`` the messages run in a Python loop over edge chunks
into the node accumulator (the reference's ``lax.scan``); the attention
denominator comes from a cheap full-edge first pass (scores are per-edge
scalars).  A short last chunk needs no padding, so no edge points at a
sink segment.

The SO(2) mix reads and writes its |m| rows through ``unbind`` and
``torch.stack``, so no index tensor is copied to the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import segment_ops as seg
from repro_torch.models.gnn import so3
from repro_torch.nn import core as nn
from repro_torch.parallel.sharding import constrain, rows_reshape

N_RBF = 8


def _rbf(dist, r_max: float = 5.0):
    centers = torch.linspace(0.0, r_max, N_RBF, dtype=dist.dtype,
                             device=dist.device)
    gamma = N_RBF / r_max
    return torch.exp(-gamma * (dist[..., None] - centers).square())


def _m_l_counts(l_max: int, m_max: int):
    """For each m in 0..m_max: the l values carrying that m."""
    return {m: list(range(m, l_max + 1)) for m in range(m_max + 1)}


def init(key_or_seed, cfg: GNNConfig, d_in: int, n_out: int, *,
         device="cuda"):
    """Params on ``device``.  A ``prng`` key replays the reference's init
    at that key: the key splits once into 6 + 16 n_layers keys, drawn in
    the order the reference's dict literals evaluate (``gnn_embed``,
    ``gnn_decoder``, then per layer ``radial``, ``alpha``, ``so2_m0``,
    ``proj``, ``ffn_l0``, ``ffn_gate``, ``ffn_mix`` and ``so2_m`` for
    m = 1..m_max).  An int or a ``torch.Generator`` draws torch's own."""
    c, lmax, mmax = cfg.d_hidden, cfg.l_max, cfg.m_max
    ml = _m_l_counts(lmax, mmax)
    keys = iter(nn.split_source(key_or_seed, 6 + cfg.n_layers * 16))

    def dense(d1, d2):
        return nn.dense_init(next(keys), d1, d2, scale="lecun",
                             device=device)

    def per_l():
        w = nn.normal(next(keys), (lmax + 1, c, c)) * (1.0 / c ** 0.5)
        return {"w": w.to(device)}

    params = {
        "gnn_embed": dense(d_in, c),
        "gnn_layers": [],
        "gnn_out_ln": nn.layernorm_init(c, device=device),
        "gnn_decoder": dense(c, n_out),
    }
    for _ in range(cfg.n_layers):
        lp = {
            "radial": nn.mlp_init(next(keys), N_RBF, [c], (mmax + 1) * c,
                                  device=device),
            "alpha": nn.mlp_init(next(keys), 2 * c + N_RBF, [c],
                                 cfg.n_heads, device=device),
            "so2_m0": dense(len(ml[0]) * c, len(ml[0]) * c),
            "so2_m": [],
            "proj": per_l(),
            "ln_scale": torch.ones((lmax + 1, c), device=device),
            "ffn_l0": nn.mlp_init(next(keys), c, [2 * c], c, device=device),
            "ffn_gate": dense(c, lmax * c),
            "ffn_mix": per_l(),
        }
        for m in range(1, mmax + 1):
            dm = len(ml[m]) * c
            lp["so2_m"].append({"wr": dense(dm, dm), "wi": dense(dm, dm)})
        params["gnn_layers"].append(lp)
    return params


def _so2_conv(lp, cfg: GNNConfig, x_rot, gates, *, truncated: bool = False):
    """SO(2) linear mix in the edge frame, truncated at m_max.

    x_rot: (E, K, C) rotated irreps — K = (l_max+1)^2 in the full layout,
    or so3.truncated_size(l_max, m_max) when ``truncated`` (only the live
    |m| <= m_max rows were rotated).  gates: (E, (m_max+1), C) radial
    gates.  Returns same layout as input with |m| > m_max components
    zeroed (full layout only).
    """
    lmax, mmax, c = cfg.l_max, cfg.m_max, cfg.d_hidden
    ml = _m_l_counts(lmax, mmax)
    e, k = x_rot.shape[0], x_rot.shape[1]

    if truncated:
        def index(l, m):
            return so3.truncated_index(l, m, lmax, mmax)
    else:
        index = so3.flat_index

    # one unbind and one stack per group: their backwards are one stack
    # and one unbind, where a view per row would allocate a zero (E, K, C)
    # gradient for each
    cols = x_rot.unbind(1)

    def rows(idx):
        return rows_reshape(torch.stack([cols[i] for i in idx], 1), (e, -1))

    out = [None] * k                 # each output row: (E, C)

    def split(y, n_rows):
        return rows_reshape(y, (e, n_rows, c))

    def put(idx, y):
        for i, row in zip(idx, y.unbind(1)):
            out[i] = row

    # m = 0
    idx0 = [index(l, 0) for l in ml[0]]
    y0 = split(nn.dense_apply(lp["so2_m0"], rows(idx0)), len(ml[0]))
    put(idx0, y0 * gates[:, 0:1, :])

    # m > 0: complex-pair mixing
    for m in range(1, mmax + 1):
        ls = ml[m]
        ip = [index(l, m) for l in ls]
        im = [index(l, -m) for l in ls]
        xp, xm = rows(ip), rows(im)
        wr, wi = lp["so2_m"][m - 1]["wr"], lp["so2_m"][m - 1]["wi"]
        yp = nn.dense_apply(wr, xp) - nn.dense_apply(wi, xm)
        ym = nn.dense_apply(wi, xp) + nn.dense_apply(wr, xm)
        g = gates[:, m:m + 1, :]
        put(ip, split(yp, len(ls)) * g)
        put(im, split(ym, len(ls)) * g)
    if any(o is None for o in out):
        zero = x_rot.new_zeros((e, c))
        out = [zero if o is None else o for o in out]
    return torch.stack(out, 1)


def _layer(lp, cfg: GNNConfig, h, graph, dirs, rbf):
    """One equivariant attention block. h: (N, K, C)."""
    s, r = graph["senders"], graph["receivers"]
    n, k, c = h.shape
    heads = cfg.n_heads
    ch = c // heads

    # ---- pass 1: attention scores (cheap, full-edge) ----
    x0 = h[:, 0, :]
    sc_in = torch.cat([seg.gather(x0, s), seg.gather(x0, r), rbf], -1)
    scores = nn.mlp_apply(lp["alpha"], sc_in, activation="silu")
    alpha = seg.segment_softmax(scores, r, n)            # (E, heads)
    # zero-length edges (self-loops) have no direction: an align-to-z
    # frame would be arbitrary and BREAK equivariance, so their conv
    # messages are masked out (self-interaction lives in the residual/FFN
    # path instead).
    valid = ((dirs * dirs).sum(-1) > 0.25).to(alpha.dtype)
    alpha = alpha * valid[:, None]

    gates_all = rows_reshape(F.silu(
        nn.mlp_apply(lp["radial"], rbf, activation="silu")
    ), (-1, cfg.m_max + 1, c))

    # ---- pass 2: eSCN conv, chunked over edges ----
    # only |m| <= m_max rotated components are live in the SO(2) mix, so
    # the rotation keeps 29/49 rows (l_max=6, m_max=2): an exact rewrite.
    def conv_chunk(sc, dc, gc, ac):
        d_blocks = so3.wigner_align_z(cfg.l_max, dc)
        xs = seg.gather(h, sc)                           # (e, K, C)
        x_rot = so3.apply_wigner_truncated(d_blocks, xs, cfg.m_max)
        y_rot = _so2_conv(lp, cfg, x_rot, gc, truncated=True)
        y = so3.apply_wigner_expand(d_blocks, y_rot, cfg.m_max)
        # attention-weight per head
        y = rows_reshape(y, (*y.shape[:-1], heads, ch)) \
            * ac[:, None, :, None]
        return rows_reshape(y, (*y.shape[:-2], c))

    e_total = s.shape[0]
    chunk = cfg.edge_chunk or GNNConfig.edge_chunk
    if e_total > chunk:
        agg = h.new_zeros((n, k, c))
        for lo in range(0, e_total, chunk):
            sl = slice(lo, lo + chunk)
            y = conv_chunk(s[sl], dirs[sl], gates_all[sl], alpha[sl])
            agg = seg.add_at(agg, r[sl], y)
    else:
        y = constrain(conv_chunk(s, dirs, gates_all, alpha), "edges", None,
                      None)
        agg = seg.scatter_sum(y, r, n)

    # ---- node update ----
    agg = _per_l_mix(lp["proj"]["w"], cfg.l_max, agg)
    h = h + agg
    h = _equivariant_ln(lp["ln_scale"], cfg.l_max, h)

    # ---- gated FFN ----
    f0 = nn.mlp_apply(lp["ffn_l0"], h[:, 0, :], activation="silu")
    gate = torch.sigmoid(nn.dense_apply(lp["ffn_gate"], h[:, 0, :]))
    gate = rows_reshape(gate, (n, cfg.l_max, c))
    hl = _per_l_mix(lp["ffn_mix"]["w"], cfg.l_max, h)
    upd = torch.cat([f0[:, None, :],
                     hl[:, 1:, :] * _expand_l(gate, cfg.l_max)], 1)
    return constrain(h + upd, "nodes", None, None)


def _expand_l(per_l, l_max: int):
    """(N, l_max, C) per-l gates -> (N, K - 1, C) broadcast over m."""
    reps = [per_l[:, l - 1:l, :].expand(-1, 2 * l + 1, -1)
            for l in range(1, l_max + 1)]
    return torch.cat(reps, 1)


def _per_l_mix(w, l_max: int, h):
    """Per-l channel mixing: w (l_max+1, C, C), h (N, K, C)."""
    return torch.cat([nn.dot(xl, w[l])
                      for l, xl in enumerate(so3.split_l(h, l_max))], 1)


def _equivariant_ln(scale, l_max: int, h, eps: float = 1e-5):
    """Per-l norm: LayerNorm over the channels for l = 0 (the population
    variance, as ``jnp.var``), RMS over (m, channels) for l > 0."""
    outs = []
    for l, xl in enumerate(so3.split_l(h, l_max)):
        if l == 0:
            mu = xl.mean(-1, keepdim=True)
            var = torch.var(xl, dim=-1, keepdim=True, correction=0)
            y = (xl - mu) * torch.rsqrt(var + eps)
        else:
            nrm = xl.square().mean((-2, -1), keepdim=True)
            y = xl * torch.rsqrt(nrm + eps)
        outs.append(y * scale[l][None, None, :])
    return torch.cat(outs, 1)


def apply(params, cfg: GNNConfig, graph):
    """graph: x (N, F), pos (N, 3), senders/receivers (E,) -> (N, n_out)."""
    x, pos = graph["x"], graph["pos"]
    s, r = graph["senders"], graph["receivers"]
    n = x.shape[0]
    k = (cfg.l_max + 1) ** 2

    dx = seg.gather(pos, s) - seg.gather(pos, r)
    dist = torch.linalg.vector_norm(dx, dim=-1)
    dirs = dx / dist.clamp_min(1e-9)[:, None]
    rbf = _rbf(dist)

    h0 = nn.dense_apply(params["gnn_embed"], x)          # (N, C) invariant
    h = torch.cat([h0[:, None, :], h0.new_zeros((n, k - 1, cfg.d_hidden))],
                  1)

    for lp in params["gnn_layers"]:
        h = _layer(lp, cfg, h, graph, dirs, rbf)

    inv = nn.layernorm_apply(params["gnn_out_ln"], h[:, 0, :])
    return nn.dense_apply(params["gnn_decoder"], inv)
