"""Rotary position embeddings (llama rotate-half convention).

Port of ``repro.nn.rope``: the angles and the rotation in fp32, the
result in x's dtype.
"""

from __future__ import annotations

import torch


def rope_cos_sin(positions, head_dim: int, theta: float = 10000.0,
                 dtype=torch.float32):
    """cos/sin tables for given integer positions.

    positions: (..., S) int -> cos/sin: (..., S, head_dim//2)
    """
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (..., S, D//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    out1 = x1f * c - x2f * s
    out2 = x2f * c + x1f * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
