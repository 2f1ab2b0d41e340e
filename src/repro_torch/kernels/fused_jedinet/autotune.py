"""Shared-memory layouts and launch choices of the JEDI-net kernels.

The *team* layout below is shared by the edge block
(``kernels/csrc/fused_jedinet_edge.cu``, B3, which stops at Ebar and has
no f_O / phi_O regions) and by the whole network
(``kernels/csrc/fused_jedinet_full.cu``, B1) where f_R is wider than a
lane's registers or a sender tile is pinned; the *warp* design of both
(:func:`plan_full` for B1, :func:`plan_edge` for B3: one thread per
edge, a block walking events) has its plans at the end of this module.
The team layout gives one block ``events_per_block`` whole events.
Everything a block touches lives in its dynamic shared memory, in the
regions below (fp32 words, every region a multiple of 4 words so
``float4`` loads stay aligned):

===========  =============================  ============================
region       words                           holds
===========  =============================  ============================
``w``        sum(in * out_p) over entries    all weights, upcast to fp32
``b``        sum(out_p) of biased entries    all biases (fp32)
``x``        E * N_o * P                     the block's events
``ebar``     E * N_o * De_p                  the sender sums
``part``     E * N_o * KS * De_p             per-split partial sums
``us``       E * S * H1_p                    u_s of one sender tile
``obuf``     E * N_o * Do_p                  f_O outputs per node (B1)
``osum``     E * Do_p                        node sums (B1)
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


def pad4(n: int) -> int:
    """``n`` rounded up to a multiple of 4 words (one ``float4``)."""
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


def kernel_entries(n_features: int, fr_widths, fo_widths=(),
                   phi_widths=()) -> list[Entry]:
    """Entries in kernel order: w1r, w1s, f_R rest, f_O, phi_O (f_R's
    alone for the edge block: no ``fo_widths`` / ``phi_widths``)."""
    p, d_e = n_features, fr_widths[-1]
    dims = [(p, fr_widths[0], True), (p, fr_widths[0], False)]
    dims += [(i, o, True) for i, o in zip(fr_widths[:-1], fr_widths[1:])]
    fo_in = [p + d_e, *fo_widths[:-1]]
    dims += [(i, o, True) for i, o in zip(fo_in, fo_widths)]
    if phi_widths:
        phi_in = [fo_widths[-1], *phi_widths[:-1]]
        dims += [(i, o, True) for i, o in zip(phi_in, phi_widths)]
    out, w_off, b_off = [], 0, 0
    for i, o, biased in dims:
        out.append(Entry(i, o, pad4(o), w_off, b_off if biased else -1))
        w_off += i * pad4(o)
        b_off += pad4(o) if biased else 0
    return out


def weight_words(entries) -> tuple[int, int]:
    """Words of the ``w`` and ``b`` regions: every weight padded to
    ``out_p`` columns, and the biases (rounded up to 4 words)."""
    return (sum(e.in_dim * e.out_p for e in entries),
            pad4(sum(e.out_p for e in entries if e.b_off >= 0)))


def region_offsets(regions) -> tuple[dict, int]:
    """Word offsets of ``[(name, words), ...]`` laid out in order, and
    their total."""
    offsets, off = {}, 0
    for name, words in regions:
        offsets[name] = off
        off += words
    return offsets, off


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
    design: str = "team"    # "team", "warp" (B1, B3) or "rows" (B2)

    @property
    def smem_bytes(self) -> int:
        return 4 * self.smem_words

    @property
    def batch_bytes(self) -> int:
        """Shared memory one more event of a batch adds to a block, which
        sizes the serving buckets: the team layout's blocks hold
        ``events_per_block`` events each, so ``per_event_bytes``; the
        other designs' blocks walk the batch one event at a time, so
        none (any batch, no tile)."""
        return self.per_event_bytes if self.design == "team" else 0


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
    """``d_o = 0``: the edge block (no C, f_O or phi_O)."""
    h1_p, de_p, do_p = entries[0].out_p, pad4(d_e), pad4(d_o)
    mw = pad4(max(max(e.out_p for e in entries),
                 p + d_e if d_o else 0, d_o))
    slot_stride = 2 * mw + h1_p
    slot_stride += 1 - slot_stride % 2          # odd: conflict-free slots
    w_words, b_words = weight_words(entries)
    offsets, off = region_offsets([
        ("w", w_words), ("b", b_words),
        ("x", pad4(epb * n_o * p)), ("ebar", epb * n_o * de_p),
        ("part", epb * n_o * ks * de_p), ("us", epb * bs * h1_p),
        ("obuf", epb * n_o * do_p), ("osum", epb * do_p),
        ("slot", (threads // team) * slot_stride),
    ])
    per_event = n_o * p + n_o * de_p + n_o * ks * de_p + bs * h1_p \
        + n_o * do_p + do_p
    reserved = w_words + b_words + (threads // team) * slot_stride
    return Layout(epb, bs, ks, team, threads, mw, slot_stride,
                  offsets, off, 4 * per_event, 4 * reserved)


def plan_launch(n_objects: int, n_features: int, fr_widths, fo_widths=(),
                phi_widths=(), *, block_s: int | None = None,
                budget_bytes: int = SMEM_BLOCK_BYTES) -> Layout:
    """Choose (events per block, sender tile, splits, team, threads) and
    lay out shared memory; raises ``ValueError`` when nothing fits.
    Without ``fo_widths`` / ``phi_widths``: the edge block's launch."""
    n_o, p = int(n_objects), int(n_features)
    entries = kernel_entries(p, fr_widths, fo_widths, phi_widths)
    d_e, d_o = fr_widths[-1], (fo_widths[-1] if fo_widths else 0)
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
    kernel = "whole-network" if fo_widths else "edge-block"
    raise ValueError(
        f"no launch of the {kernel} kernel fits {budget_bytes} bytes "
        f"of shared memory at N_o={n_o}, P={p}, widths fr={list(fr_widths)} "
        f"fo={list(fo_widths)} phi={list(phi_widths)}, block_s={block_s}")


def layout_for(cfg, params, *, block_s: int | None = None) -> Layout:
    """:func:`plan_launch` for a config and its (raw or quantized) params:
    the team layout, whose per-event bytes and reservation set the
    ``fused_full`` bucket ladder (B1's warp design has no batch tile: it
    takes any batch, one event per block at a time)."""
    return plan_launch(cfg.n_objects, cfg.n_features,
                       mlp_widths(params["fr"]), mlp_widths(params["fo"]),
                       mlp_widths(params["phi"]), block_s=block_s)


# ---- B1's own plan ---------------------------------------------------------
#: Register widths of B1's warp design (``RW`` in the source), the most
#: threads a block of each may have (``warp_threads``) and the receivers a
#: lane takes at once (``warp_rpl``): RPL x RW activations and as many
#: sums per lane must fit the block's registers.
WARP_REG_WIDTHS = {20: 512, 32: 256, 64: 256}
WARP_RPL = {20: 2, 32: 2, 64: 1}


#: The widest D_e of B1's warp design (``kEdgeRegs``).
WARP_EDGE_REGS = 8


def full_design(fr_widths, block_s: int | None = None) -> str:
    """B1's design for f_R's widths (``[h1, ..., d_e]``): ``"warp"``
    where every width fits a lane's registers (D_e at most
    :data:`WARP_EDGE_REGS`) and no sender tile is pinned, else
    ``"team"`` (the first port's layout, which ``block_s`` pins)."""
    if block_s is None and max(fr_widths) <= max(WARP_REG_WIDTHS) \
            and fr_widths[-1] <= WARP_EDGE_REGS:
        return "warp"
    return "team"


def _warp_shape(n_o: int, fr_widths, readout: bool):
    """(RW, receivers per compute warp, compute warps) of the warp design:
    the narrowest register width that holds f_R, then as few groups of
    RPL receivers per warp as the block's threads allow (less the
    readout warp, where there is one)."""
    rw = min(w for w in WARP_REG_WIDTHS if w >= max(fr_widths))
    rpl = WARP_RPL[rw]
    units = -(-n_o // rpl)                        # groups of RPL receivers
    max_warps = WARP_REG_WIDTHS[rw] // WARP - int(readout)
    per_warp = -(-units // max_warps)             # groups per warp
    return rw, per_warp * rpl, -(-units // per_warp)


def _fr_padded_words(fr_widths, rw: int) -> int:
    """Words of f_R's layers after the first, zero-padded to rw x rw (the
    last to rw x WARP_EDGE_REGS), then their biases padded the same
    way (``pool`` of the warp designs)."""
    n_rest = len(fr_widths) - 1
    return 0 if n_rest == 0 else pad4((n_rest - 1) * (rw * rw + rw)
                                      + rw * WARP_EDGE_REGS + WARP_EDGE_REGS)


def _warp_layout(n_o, p, entries, d_e, d_o, fr_widths, fo_widths,
                 phi_widths) -> Layout:
    rw, ks, warps = _warp_shape(n_o, fr_widths, readout=True)
    h1_p, do_p = entries[0].out_p, pad4(d_o)
    ust = h1_p | 1                                # odd: conflict-free rows
    n_fr = len(fr_widths) + 1                     # w1r, w1s, the rest
    fst = max([pad4(p + d_e)] + [e.out_p for e in
                                 entries[n_fr:n_fr + len(fo_widths)]]) | 1
    half = pad4(max(d_o, *phi_widths))
    w_words, b_words = weight_words(entries)
    offsets, off = region_offsets(
        [("w", w_words), ("b", b_words),
         ("x", pad4(n_o * p)), ("part", pad4(n_o * ust)),
         ("us", pad4(n_o * ust)), ("ebar", pad4(2 * n_o * fst)),
         ("obuf", 2 * n_o * do_p), ("slot", 2 * half),
         ("pool", _fr_padded_words(fr_widths, rw))])
    per_event = pad4(n_o * p) + 2 * pad4(n_o * ust) + pad4(2 * n_o * fst) \
        + 2 * n_o * do_p
    return Layout(1, WARP, ks, 1, (warps + 1) * WARP, rw, 2 * half, offsets,
                  off, 4 * per_event, 4 * (off - per_event), design="warp")


def plan_full(n_objects: int, n_features: int, fr_widths, fo_widths,
              phi_widths, *, block_s: int | None = None,
              budget_bytes: int = SMEM_BLOCK_BYTES) -> Layout:
    """B1's launch: the warp design (one thread per edge, one warp per
    receiver, one event per block at a time) where :func:`full_design`
    says so and its shared memory fits, else the team layout of
    :func:`plan_launch`.  Layout fields of the warp design: ``block_s``
    is the 32-sender lane tile, ``ks`` the receivers per compute warp
    (taken :data:`WARP_RPL` at a time), ``threads`` the compute warps'
    and the readout warp's, ``mw`` the register width, ``slot_stride``
    the readout warp's two activation buffers; ``ebar`` holds f_O's two
    activation buffers (a row per node), ``obuf`` two events' f_O
    outputs and ``pool`` f_R's layers after the first, zero-padded to
    ``mw`` wide."""
    n_o, p = int(n_objects), int(n_features)
    if full_design(fr_widths, block_s) == "warp":
        entries = kernel_entries(p, fr_widths, fo_widths, phi_widths)
        lay = _warp_layout(n_o, p, entries, fr_widths[-1], fo_widths[-1],
                           fr_widths, fo_widths, phi_widths)
        if lay.smem_bytes <= budget_bytes:
            return lay
    return plan_launch(n_o, p, fr_widths, fo_widths, phi_widths,
                       block_s=block_s, budget_bytes=budget_bytes)


def full_layout_for(cfg, params, *, block_s: int | None = None) -> Layout:
    """:func:`plan_full` for a config and its (raw or quantized) params:
    the launch B1 runs."""
    return plan_full(cfg.n_objects, cfg.n_features, mlp_widths(params["fr"]),
                     mlp_widths(params["fo"]), mlp_widths(params["phi"]),
                     block_s=block_s)


def _edge_warp_layout(n_o, p, entries, d_e, fr_widths) -> Layout:
    """B3's warp design: B1's without the readout warp, f_O and phi_O;
    ``ebar`` holds one event's N_o x D_e sums in device memory's order."""
    rw, ks, warps = _warp_shape(n_o, fr_widths, readout=False)
    ust = entries[0].out_p | 1                    # odd: conflict-free rows
    w_words, b_words = weight_words(entries)
    per_event = pad4(n_o * p) + 2 * pad4(n_o * ust) + pad4(n_o * d_e)
    offsets, off = region_offsets(
        [("w", w_words), ("b", b_words), ("x", pad4(n_o * p)),
         ("part", pad4(n_o * ust)), ("us", pad4(n_o * ust)),
         ("ebar", pad4(n_o * d_e)),
         ("pool", _fr_padded_words(fr_widths, rw))])
    return Layout(1, WARP, ks, 1, warps * WARP, rw, 0, offsets, off,
                  4 * per_event, 4 * (off - per_event), design="warp")


def plan_edge(n_objects: int, n_features: int, fr_widths, *,
              block_s: int | None = None,
              budget_bytes: int = SMEM_BLOCK_BYTES) -> Layout:
    """B3's launch, by B1's rule (:func:`full_design`): the warp design
    (one thread per edge, every warp computing, a block walking events)
    where f_R fits a lane's registers, no sender tile is pinned and its
    shared memory fits, else the team layout of :func:`plan_launch`.
    Layout fields of the warp design as in :func:`plan_full`, with
    ``ks`` the receivers per warp and ``threads`` all compute."""
    n_o, p = int(n_objects), int(n_features)
    if full_design(fr_widths, block_s) == "warp":
        lay = _edge_warp_layout(n_o, p, kernel_entries(p, fr_widths),
                                fr_widths[-1], fr_widths)
        if lay.smem_bytes <= budget_bytes:
            return lay
    return plan_launch(n_o, p, fr_widths, block_s=block_s,
                       budget_bytes=budget_bytes)


def edge_layout_for(cfg, params, *, block_s: int | None = None) -> Layout:
    """:func:`plan_edge` for a config and its params (only f_R's widths
    count): the launch B3 runs."""
    return plan_edge(cfg.n_objects, cfg.n_features, mlp_widths(params["fr"]),
                     block_s=block_s)
