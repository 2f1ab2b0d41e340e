"""Public entry of the flash-decode kernel (B5)."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode import kernel as K


def flash_decode(q, k, v, q_pos, kv_pos, *, window=None, chunk=None):
    """One-token GQA attention over a KV cache.

    q: (B, H, D) unscaled; k/v: (B, S, Hkv, D) fp32 or bf16; q_pos: (B,);
    kv_pos: (B, S), -1 for unwritten slots.  Returns (B, H, D) float32.
    q is scaled by 1/sqrt(D) in fp32 and grouped as (B, Hkv, G, D), G =
    H / Hkv; ``chunk`` pins the kernel's keys per sequence partition (any
    S, no divisor needed; default: the plan's).  On the card one launch
    of kernel B5 (its partitions combined in the same call); on the CPU
    its plain version.
    """
    b, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"H={h} query heads are not a multiple of "
                         f"Hkv={hkv} kv heads")
    scale = 1.0 / (d ** 0.5)
    qg = (q.float() * scale).reshape(b, hkv, h // hkv, d)
    o = K.flash_decode_kernel_call(qg, k, v, q_pos.to(torch.int32),
                                   kv_pos.to(torch.int32), chunk=chunk,
                                   window=window)
    return o.reshape(b, h, d)
