"""Shared batch-tile helpers for the port's batch-gridded kernels.

Port of ``repro.kernels.autotune``.  The TPU reference sized its batch
tile from an 8 MiB VMEM budget; on Hopper the scarce resource of a
block is its shared memory (at most 227 KB of dynamic shared memory,
after opting in with ``cudaFuncSetAttribute``) and its threads (at
most 1024).  The per-kernel models that turn a network into bytes stay
with the kernels (``fused_jedinet/autotune.py``); this module keeps the
model-agnostic rules: pick a tile from per-event bytes, and pad the
batch to the tile instead of degrading the tile.
"""

from __future__ import annotations

import torch

#: Dynamic shared memory one block may opt into on an H100 (232,448 B).
SMEM_BLOCK_BYTES = 227 * 1024

#: Threads a block may have.
MAX_THREADS_PER_BLOCK = 1024

#: Threads in a warp.
WARP = 32

# Bucket rungs below the tile are doublings from this size.
_ALIGN = 8


def effective_budget(budget_bytes: int, reserved_bytes: int) -> int:
    """Shared memory left for events after ``reserved_bytes`` (the
    block's weights and scratch), floored at 1/8 of the budget so a
    heavy reservation shrinks the tile instead of zeroing it."""
    return max(budget_bytes - max(int(reserved_bytes), 0), budget_bytes // 8)


def mlp_widths(params) -> list[int]:
    """Output widths of each layer of a ``{"layers": [{"w", "b"}, ...]}`` MLP."""
    return [int(lp["w"].shape[-1]) for lp in params["layers"]]


def pick_block_b(batch: int, per_sample_bytes: int,
                 budget_bytes: int = SMEM_BLOCK_BYTES) -> int:
    """Largest useful batch tile whose bytes fit the budget.

    Never constrained to divide ``batch`` (pad with :func:`pad_batch`):
    the whole batch if it fits; otherwise the budget-limited step count
    with the tile balanced to it, aligned to :data:`_ALIGN` when that
    still fits.
    """
    bb = max(1, min(batch, budget_bytes // max(per_sample_bytes, 1)))
    if bb >= batch:
        return batch
    steps = -(-batch // bb)
    bb = -(-batch // steps)
    if bb > _ALIGN:
        aligned = -(-bb // _ALIGN) * _ALIGN
        if aligned * per_sample_bytes <= budget_bytes:
            bb = aligned
    return bb


def bucket_ladder(max_batch: int, per_sample_bytes: int,
                  budget_bytes: int = SMEM_BLOCK_BYTES, *,
                  reserved_bytes: int = 0) -> list[int]:
    """Serving pad-to-bucket batch sizes derived from the tile.

    Below the tile: doublings from 8, each served whole; at and above
    it: whole-tile doublings, so a bucket is an exact tile multiple.
    The last bucket covers ``max_batch``.  ``reserved_bytes`` (the
    block's weights and scratch) shrinks the budget first.
    """
    max_batch = max(int(max_batch), 1)
    budget_bytes = effective_budget(budget_bytes, reserved_bytes)
    tile = pick_block_b(max_batch, per_sample_bytes, budget_bytes)
    ladder: list[int] = []
    b = _ALIGN
    while b < min(tile, max_batch):
        ladder.append(b)
        b *= 2
    t = tile
    while t < max_batch:
        ladder.append(t)
        t *= 2
    ladder.append(min(t, padded_batch(max_batch, tile)))
    return sorted(set(ladder))


def bucket_for(bucket_sizes, n_events: int) -> int:
    """Smallest bucket holding ``n_events`` (largest if none do — callers
    chunk oversized requests through it).  ``bucket_sizes`` ascending."""
    for b in bucket_sizes:
        if n_events <= b:
            return b
    return bucket_sizes[-1]


def padded_batch(batch: int, block_b: int) -> int:
    """``batch`` rounded up to the next multiple of ``block_b``."""
    return ((batch + block_b - 1) // block_b) * block_b


def pad_batch(x: torch.Tensor, block_b: int) -> torch.Tensor:
    """Zero-pad dim 0 of ``x`` up to the next ``block_b`` multiple
    (``x`` itself when nothing is missing)."""
    pad = padded_batch(x.shape[0], block_b) - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))], dim=0)
