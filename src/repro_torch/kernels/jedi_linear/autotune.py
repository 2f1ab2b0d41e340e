"""Shared-memory layout and launch choice of the JEDI-linear kernel (B2).

Replaces the reference's linear live-set VMEM model.  The CUDA kernel
(``kernels/csrc/jedi_linear_full.cu``) gives one block
``events_per_block`` whole events and keeps everything in dynamic shared
memory, in these regions (fp32 words, each a multiple of 4 words):

===========  =============================  ============================
region       words                           holds
===========  =============================  ============================
``w``        sum(in * out_p) over entries    all weights, upcast to fp32
``b``        sum(out_p) of biased entries    all biases (fp32)
``x``        E * N_o * P                     the block's events
``part``     E * KS * H1_p                   per-split partial pools
``pool``     E * H1_p                        pooled u_s per event
``obuf``     E * N_o * Do_p                  f_O outputs per node
``osum``     E * Do_p                        node sums
``slot``     teams * slot_stride             per-team buffers A | B
===========  =============================  ============================

(E events per block, KS the node splits of the pool.)  There is no
sender axis and no (N_o, H1) buffer: the kernel recomputes a node's
``u_s`` where it needs it, so an event costs O(N_o * (P + Do)) words and
jedi_tracks_128 fits.  The weights are packed as for B1
(:func:`~repro_torch.kernels.fused_jedinet.autotune.kernel_entries`), so
both kernels read the same buffers.

The choice: one node per team (``team`` threads, as for B1), about
:data:`~repro_torch.kernels.fused_jedinet.autotune.THREADS_TARGET`
threads per block; the pool's nodes split ``KS`` ways so about as many
threads share it; events per block halved until the layout fits.
"""

from __future__ import annotations

from repro_torch.kernels.autotune import (
    MAX_THREADS_PER_BLOCK,
    SMEM_BLOCK_BYTES,
    WARP,
    mlp_widths,
)
from repro_torch.kernels.fused_jedinet.autotune import (
    THREADS_TARGET,
    Layout,
    pad4,
    kernel_entries,
    team_size,
)


def plan_linear(n_objects: int, n_features: int, fr_widths, fo_widths,
                phi_widths, *,
                budget_bytes: int = SMEM_BLOCK_BYTES) -> Layout:
    """Choose (events per block, pool splits, team, threads) and lay out
    shared memory; raises ``ValueError`` when nothing fits."""
    n_o, p = int(n_objects), int(n_features)
    entries = kernel_entries(p, fr_widths, fo_widths, phi_widths)
    h1_p, do_p = entries[0].out_p, pad4(fo_widths[-1])
    mw = pad4(max(max(e.out_p for e in entries), p + fr_widths[-1],
                 fo_widths[-1]))
    team = team_size(mw)
    slot_stride = 2 * mw
    slot_stride += 1 - slot_stride % 2          # odd: conflict-free slots
    w_words = sum(e.in_dim * e.out_p for e in entries)
    b_words = pad4(sum(e.out_p for e in entries if e.b_off >= 0))
    epb = max(1, THREADS_TARGET // (n_o * team))
    while True:
        threads = min(-(-(epb * n_o * team) // WARP) * WARP, THREADS_TARGET,
                      MAX_THREADS_PER_BLOCK)
        threads = max(threads, team)
        ks = max(1, min(n_o, threads // (epb * (h1_p // 4))))
        slots = (threads // team) * slot_stride
        regions = [
            ("w", w_words), ("b", b_words), ("x", pad4(epb * n_o * p)),
            ("part", epb * ks * h1_p), ("pool", epb * h1_p),
            ("obuf", epb * n_o * do_p), ("osum", epb * do_p),
            ("slot", slots),
        ]
        offsets, off = {}, 0
        for name, words in regions:
            offsets[name] = off
            off += words
        per_event = n_o * p + ks * h1_p + h1_p + n_o * do_p + do_p
        lay = Layout(epb, n_o, ks, team, threads, mw, slot_stride, offsets,
                     off, 4 * per_event, 4 * (w_words + b_words + slots))
        if lay.smem_bytes <= budget_bytes:
            return lay
        if epb == 1:
            break
        epb //= 2
    raise ValueError(
        f"no launch of the JEDI-linear kernel fits {budget_bytes} bytes of "
        f"shared memory at N_o={n_o}, P={p}, widths fr={list(fr_widths)} "
        f"fo={list(fo_widths)} phi={list(phi_widths)}")


def layout_for(cfg, params) -> Layout:
    """:func:`plan_linear` for a config and its (raw or quantized) params."""
    return plan_linear(cfg.n_objects, cfg.n_features,
                       mlp_widths(params["fr"]), mlp_widths(params["fo"]),
                       mlp_widths(params["phi"]))
