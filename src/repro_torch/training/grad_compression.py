"""Error-feedback int8 gradient compression for the data-parallel all-reduce.

Port of ``repro.training.grad_compression``.  Compressing grads to int8
with per-leaf scales cuts the all-reduce's bytes 4x (fp32); error
feedback (Seide et al. 2014; Karimireddy et al. 2019, arXiv:1901.09847)
carries the quantization residual into the next step.

Each rank quantizes (grad + residual), all-reduces the int payload as
int32 partial sums (exact accumulation), all-reduces the scales,
dequantizes with the mean scale, and keeps its local residual.  The
reference's ``axis_name`` inside ``shard_map`` is a ``torch.distributed``
process group here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.common.tree import tree_leaves, tree_unflatten


def quantize(x: torch.Tensor, *, bits: int = 8):
    """Symmetric per-tensor int quantization, round half to even.
    Returns (q int8/int16, scale 0-d fp32)."""
    if bits not in (8, 16):
        raise ValueError(f"bits must be 8 or 16, not {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    amax = x.abs().max()
    scale = torch.clamp(amax, min=1e-20) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q.to(torch.int8 if bits == 8 else torch.int16), \
        scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compressed_psum(grads, residuals, group=None, *, bits: int = 8):
    """Error-feedback compressed all-reduce over ``group`` (default: the
    world).

    grads/residuals: trees of fp32 leaves (this rank's gradients).
    Returns (mean_grads, new_residuals).  Every rank of the group must
    call it with trees of the same structure and shapes.
    """
    n = dist.get_world_size(group)

    def one(g, r):
        corrected = g + r
        q, scale = quantize(corrected, bits=bits)
        # int32 accumulation is exact; scales are averaged separately
        # (per-rank scale variation is second-order with error feedback).
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, group=group)
        ssum = scale.reshape(1).clone()
        dist.all_reduce(ssum, group=group)
        mean = qsum.to(torch.float32) * (ssum[0] / n) / n
        new_r = corrected - dequantize(q, scale)      # local residual
        return mean, new_r

    flat_g = tree_leaves(grads)
    flat_r = tree_leaves(residuals)
    out = [one(g, r) for g, r in zip(flat_g, flat_r)]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
