"""Plain PyTorch version of the flash-decode kernel (one-token GQA
attention)."""

from __future__ import annotations

import torch

#: The reference's mask value: finite, so a row with no valid key gives the
#: mean of v instead of NaN.
NEG_INF = -1e30


def flash_decode_ref(q, k, v, q_pos, kv_pos, *, window=None):
    """q: (B, Hkv, G, D) pre-scaled; k/v: (B, S, Hkv, D);
    q_pos: (B,) int32; kv_pos: (B, S) int32 (-1 invalid).
    Returns (B, Hkv, G, D) float32.
    """
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float())
    ok = kv_pos >= 0
    ok &= kv_pos <= q_pos[:, None]
    if window is not None:
        ok &= (q_pos[:, None] - kv_pos) < window
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return o / l.clamp_min(1e-30)
