"""Attention: GQA grouped-head attention with causal / sliding-window masks.

Port of ``repro.nn.attention``, plain PyTorch as the reference is plain
XLA.  Two execution paths, numerically identical:

* full      — one einsum, softmax over the whole KV axis (short
  sequences);
* blockwise — a loop over KV chunks with an online-softmax carry
  (running max / denominator / accumulator), optionally also over query
  chunks, so the (Sq x Skv) score matrix never exists at once.

Masking is positional: callers pass integer positions for q and kv;
invalid KV slots (unwritten cache entries) carry position -1 and are
masked out.  Sliding-window attention (h2o-danube) adds
``q_pos - kv_pos < window``.  The LM's decode step does not come here on
the card: its one-token attention is kernel B5 (``kernels/flash_decode``),
which computes this function at ``Sq == 1`` with the same mask and the
same finite ``NEG_INF``.

bf16 rounds where the reference rounds: q is scaled in its own dtype
(:func:`scale_q`), scores and PV products are exact products of the
operands summed in fp32, p is cast to v's dtype before the PV product,
and the output is in v's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import flatten_ready

NEG_INF = -1e30


def scale_q(q: torch.Tensor) -> torch.Tensor:
    """q * 1/sqrt(D) in q's dtype, the scale rounded to that dtype first,
    as ``jnp`` multiplies an array by a Python float.  The rounded scale
    is a host float (exact in fp32), so no device scalar is made per
    call."""
    scale = float(torch.tensor(1.0 / (q.shape[-1] ** 0.5), dtype=q.dtype))
    return q * scale


def _mask_bias(q_pos, kv_pos, *, causal: bool, window):
    """(B, Sq, Skv) additive fp32 bias from positional masking rules."""
    qp = q_pos[..., :, None].to(torch.int32)
    kp = kv_pos[..., None, :].to(torch.int32)
    ok = kp >= 0                                   # valid cache slot
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & ((qp - kp) < window)
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill(~ok, NEG_INF)


def _scores(q, k):
    # q: (B, Sq, Hkv, G, D)  k: (B, Skv, Hkv, D) -> (B, Hkv, G, Sq, Skv)
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def _pv(p, v, spec: str):
    """p cast to v's dtype, then exact products summed in fp32."""
    return torch.einsum(spec, p.to(v.dtype).float(), v.float())


def _attend_full(q, k, v, bias):
    s = _scores(q, k) + bias[:, None, None, :, :]  # scale pre-applied to q
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF / 2)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = _pv(p, v, "bhgqk,bkhd->bqhgd")
    l = l.movedim((1, 2, 3), (2, 3, 1))            # (B, Sq, Hkv, G, 1)
    return (o / l.clamp_min(1e-30)).to(v.dtype)


def _attend_blockwise(q, k, v, bias, kv_chunk: int):
    b, sq, hkv, g, d = q.shape
    skv = k.shape[1]
    n_chunks = -(-skv // kv_chunk)
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        bias = F.pad(bias, (0, pad), value=NEG_INF)
    dev = q.device
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, v.shape[-1]), dtype=torch.float32,
                      device=dev)
    for c in range(0, n_chunks * kv_chunk, kv_chunk):
        kc, vc = k[:, c:c + kv_chunk], v[:, c:c + kv_chunk]
        s = _scores(q, kc) + bias[:, None, None, :, c:c + kv_chunk]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _pv(p, vc, "bhgqk,bkhd->bhgqd")
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.movedim((1, 2), (2, 3)).to(v.dtype)  # (B, Sq, Hkv, G, D)


def attention(q, k, v, *, q_pos, kv_pos, causal: bool = True,
              window=None, kv_chunk=None, q_chunk=None):
    """Grouped-query attention.

    q, k: (B, Sq | Skv, H | Hkv, D); v: (B, Skv, Hkv, Dv) (Dv = D but for
    MLA's prefill); H % Hkv == 0.
    q_pos: (B, Sq) int; kv_pos: (B, Skv) int, -1 for invalid slots.
    Returns (B, Sq, H, Dv) in v's dtype.
    """
    # the einsums flatten (batch, heads): sharded q / k / v keep only
    # their batch axis sharded (a redistribution seam, as in nn.core.dot)
    q, k, v = (flatten_ready(t, 0, t.dim() - 2) for t in (q, k, v))
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"H={h} query heads are not a multiple of "
                         f"Hkv={hkv} kv heads")
    g = h // hkv
    qg = scale_q(q).reshape(b, sq, hkv, g, d)

    def run(qg_, qpos_):
        bias = _mask_bias(qpos_, kv_pos, causal=causal, window=window)
        if kv_chunk is not None and k.shape[1] > kv_chunk:
            return _attend_blockwise(qg_, k, v, bias, kv_chunk)
        return _attend_full(qg_, k, v, bias)

    if q_chunk is not None and sq > q_chunk and sq % q_chunk == 0:
        o = torch.cat([run(qg[:, c:c + q_chunk], q_pos[:, c:c + q_chunk])
                       for c in range(0, sq, q_chunk)], dim=1)
    else:
        o = run(qg, q_pos)
    return o.reshape(b, sq, h, v.shape[-1])
