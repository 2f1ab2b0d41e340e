"""Shared-memory layout and launch choice of the whole-network kernel.

The CUDA kernel (``kernels/csrc/fused_jedinet_full.cu``) gives one
block ``events_per_block`` whole events.  Everything a block touches
lives in its dynamic shared memory, in the regions below (fp32 words,
every region a multiple of 4 words so ``float4`` loads stay aligned):

===========  =============================  ============================
region       words                           holds
===========  =============================  ============================
``w``        sum(in * out_p) over entries    all weights, upcast to fp32
``b``        sum(out_p) of biased entries    all biases (fp32)
``x``        E * N_o * P                     the block's events
``ebar``     E * N_o * De_p                  the sender sums
``part``     E * N_o * KS * De_p             per-split partial sums
``us``       E * S * H1_p                    u_s of one sender tile
``obuf``     E * N_o * Do_p                  f_O outputs per node
``osum``     E * Do_p                        node sums
``slot``     teams * slot_stride             per-team activation buffers
===========  =============================  ============================

(E events per block, S the sender tile, KS the sender splits, ``_p``
widths rounded up to 4 with zero columns.)  Python is the one source of
this layout: the wrapper passes every offset to the kernel, and the
tests check it here on the CPU.

The choice: a *team* of ``team`` threads computes one grid cell's MLP,
one output chunk of 4 per thread and pass (``team = 1`` up to width 32,
wider layers split across more threads).  Each receiver's senders are
split ``KS`` ways so a block has about :data:`THREADS_TARGET` threads;
the sender tile is the whole N_o where it fits, else the largest tile
that fits.  Weights dominate the reservation; events dominate the rest.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels.autotune import (
    MAX_THREADS_PER_BLOCK,
    SMEM_BLOCK_BYTES,
    WARP,
    mlp_widths,
)

#: Threads a block aims for: enough warps to hide shared-memory latency,
#: few enough that several blocks share an SM.
THREADS_TARGET = 256


def _r4(n: int) -> int:
    return -(-int(n) // 4) * 4


@dataclasses.dataclass(frozen=True)
class Entry:
    """One weight tensor as the kernel sees it (``w1`` is two entries:
    the receiver and sender halves of f_R's first layer)."""

    in_dim: int
    out_dim: int
    out_p: int          # out_dim rounded up to 4 (zero columns)
    w_off: int          # word offset of the (in_dim, out_p) block in ``w``
    b_off: int          # word offset of its bias in ``b``; -1: no bias


def kernel_entries(n_features: int, fr_widths, fo_widths,
                   phi_widths) -> list[Entry]:
    """Entries in kernel order: w1r, w1s, f_R rest, f_O, phi_O."""
    p, d_e = n_features, fr_widths[-1]
    dims = [(p, fr_widths[0], True), (p, fr_widths[0], False)]
    dims += [(i, o, True) for i, o in zip(fr_widths[:-1], fr_widths[1:])]
    fo_in = [p + d_e, *fo_widths[:-1]]
    dims += [(i, o, True) for i, o in zip(fo_in, fo_widths)]
    phi_in = [fo_widths[-1], *phi_widths[:-1]]
    dims += [(i, o, True) for i, o in zip(phi_in, phi_widths)]
    out, w_off, b_off = [], 0, 0
    for i, o, biased in dims:
        out.append(Entry(i, o, _r4(o), w_off, b_off if biased else -1))
        w_off += i * _r4(o)
        b_off += _r4(o) if biased else 0
    return out


@dataclasses.dataclass(frozen=True)
class Layout:
    """One launch of the kernel: its choice and its shared-memory map."""

    events_per_block: int
    block_s: int            # sender tile
    ks: int                 # sender splits per receiver
    team: int               # threads per grid cell
    threads: int            # threads per block
    mw: int                 # width of one activation buffer
    slot_stride: int        # words per team slot (A | B | U), odd
    offsets: dict           # region -> word offset
    smem_words: int
    per_event_bytes: int    # bytes one more event adds
    reserved_bytes: int     # bytes before the first event

    @property
    def smem_bytes(self) -> int:
        return 4 * self.smem_words


def team_size(mw: int) -> int:
    """Threads per grid cell: 1 up to width 32, then enough threads that
    each computes at most 16 outputs of the widest layer (power of 2,
    at most a warp)."""
    if mw <= 32:
        return 1
    t = 1
    while t * 16 < mw and t < WARP:
        t *= 2
    return t


def _layout(n_o, p, entries, d_e, d_o, epb, bs, ks, team, threads) -> Layout:
    h1_p, de_p, do_p = entries[0].out_p, _r4(d_e), _r4(d_o)
    mw = _r4(max(max(e.out_p for e in entries), p + d_e, d_o))
    slot_stride = 2 * mw + h1_p
    slot_stride += 1 - slot_stride % 2          # odd: conflict-free slots
    w_words = sum(e.in_dim * e.out_p for e in entries)
    b_words = _r4(sum(e.out_p for e in entries if e.b_off >= 0))
    regions = [
        ("w", w_words), ("b", b_words),
        ("x", _r4(epb * n_o * p)), ("ebar", epb * n_o * de_p),
        ("part", epb * n_o * ks * de_p), ("us", epb * bs * h1_p),
        ("obuf", epb * n_o * do_p), ("osum", epb * do_p),
        ("slot", (threads // team) * slot_stride),
    ]
    offsets, off = {}, 0
    for name, words in regions:
        offsets[name] = off
        off += words
    per_event = n_o * p + n_o * de_p + n_o * ks * de_p + bs * h1_p \
        + n_o * do_p + do_p
    reserved = w_words + b_words + (threads // team) * slot_stride
    return Layout(epb, bs, ks, team, threads, mw, slot_stride,
                  offsets, off, 4 * per_event, 4 * reserved)


def plan_launch(n_objects: int, n_features: int, fr_widths, fo_widths,
                phi_widths, *, block_s: int | None = None,
                budget_bytes: int = SMEM_BLOCK_BYTES) -> Layout:
    """Choose (events per block, sender tile, splits, team, threads) and
    lay out shared memory; raises ``ValueError`` when nothing fits."""
    n_o, p = int(n_objects), int(n_features)
    entries = kernel_entries(p, fr_widths, fo_widths, phi_widths)
    d_e, d_o = fr_widths[-1], fo_widths[-1]
    probe = _layout(n_o, p, entries, d_e, d_o, 1, 1, 1, 1, WARP)
    team = team_size(probe.mw)
    if block_s is not None:
        tiles = [max(1, min(int(block_s), n_o))]
    else:
        tiles = [n_o] + [s for s in (96, 64, 48, 32, 24, 16, 8) if s < n_o]
    for bs in tiles:
        ks = max(1, min(bs, THREADS_TARGET // (n_o * team)))
        epb = max(1, THREADS_TARGET // (n_o * ks * team))
        while True:
            items = epb * n_o * ks * team
            threads = min(-(-items // WARP) * WARP, THREADS_TARGET,
                          MAX_THREADS_PER_BLOCK)
            threads = max(threads, team)
            lay = _layout(n_o, p, entries, d_e, d_o, epb, bs, ks, team,
                          threads)
            if lay.smem_bytes <= budget_bytes:
                return lay
            if epb > 1:
                epb //= 2
            elif ks > 1:
                ks //= 2
            else:
                break
    raise ValueError(
        f"no launch of the whole-network kernel fits {budget_bytes} bytes "
        f"of shared memory at N_o={n_o}, P={p}, widths fr={list(fr_widths)} "
        f"fo={list(fo_widths)} phi={list(phi_widths)}, block_s={block_s}")


def layout_for(cfg, params, *, block_s: int | None = None) -> Layout:
    """:func:`plan_launch` for a config and its (raw or quantized) params."""
    return plan_launch(cfg.n_objects, cfg.n_features,
                       mlp_widths(params["fr"]), mlp_widths(params["fo"]),
                       mlp_widths(params["phi"]), block_s=block_s)
