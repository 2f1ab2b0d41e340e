"""Shared-memory layouts and launch choice of the JEDI-linear kernel (B2).

Replaces the reference's linear live-set VMEM model.  The CUDA kernel
(``kernels/csrc/jedi_linear_full.cu``) has two designs, and
:func:`plan_linear` picks one per shape (``Layout.design``):

*rows* (:func:`_rows_layout`), wherever it fits (jedi_30p, jedi_50p): a
block walks events, one at a time, with a row per node in each of three
buffers; compute warps plus one readout warp.  Its regions (fp32 words,
each a multiple of 4 words; ``st`` the row stride, odd and at least P +
D_e and every f_R and f_O width, carried in ``mw``):

===========  =============================  ============================
region       words                           holds
===========  =============================  ============================
``w``        sum(in * out_p) over entries    all weights, upcast to fp32
``b``        sum(out_p) of biased entries    all biases (fp32)
``x``        N_o * P                         the event
``part``     N_o * st                        u_r, then h (the node rows)
``us``       N_o * st                        u_s
``ebar``     N_o * st                        C = [x || h]
``pool``     H1_p                            the pooled u_s
``obuf``     2 * N_o * Do_p                  f_O outputs, two events
``slot``     2 * half                        the readout warp's buffers
===========  =============================  ============================

*team*, where the rows do not fit beside the weights (jedi_tracks_128):
the first port's layout, one block ``events_per_block`` whole events:

===========  =============================  ============================
region       words                           holds
===========  =============================  ============================
``w``, ``b`` as above
``x``        E * N_o * P                     the block's events
``part``     E * KS * H1_p                   per-split partial pools
``pool``     E * H1_p                        pooled u_s per event
``obuf``     E * N_o * Do_p                  f_O outputs per node
``osum``     E * Do_p                        node sums
``slot``     teams * slot_stride             per-team buffers A | B
===========  =============================  ============================

(E events per block, KS the node splits of the pool.)  There is no
sender axis and no (N_o, H1) buffer: the team kernel recomputes a node's
``u_s`` where it needs it, so an event costs O(N_o * (P + Do)) words and
jedi_tracks_128 fits.  One node per team (``team`` threads, as for B1),
about :data:`~repro_torch.kernels.fused_jedinet.autotune.THREADS_TARGET`
threads per block; the pool's nodes split ``KS`` ways so about as many
threads share it; events per block halved until the layout fits.

The weights are packed as for B1
(:func:`~repro_torch.kernels.fused_jedinet.autotune.kernel_entries`), so
the kernels read the same buffers.
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
    kernel_entries,
    pad4,
    region_offsets,
    team_size,
    weight_words,
)


#: The most compute warps of the rows design (its block has at most 512
#: threads with the readout warp).
ROWS_MAX_COMPUTE_WARPS = 15


def _rows_layout(n_o, p, entries, fr_widths, fo_widths, phi_widths) -> Layout:
    n_fr = len(fr_widths) + 1                     # w1r, w1s, the rest
    rows = entries[:n_fr + len(fo_widths)]        # f_R's and f_O's layers
    h1_p, do_p = entries[0].out_p, pad4(fo_widths[-1])
    st = max([pad4(p + fr_widths[-1])] + [e.out_p for e in rows]) | 1
    half = pad4(max(fo_widths[-1], *phi_widths))
    # enough compute warps for the widest phase: u_r and u_s (a thread
    # per node and 4 columns of each), or a layer of f_R or f_O
    items = max(2 * n_o * h1_p // 4, n_o * max(e.out_p for e in rows) // 4)
    n_cw = min(ROWS_MAX_COMPUTE_WARPS, -(-items // WARP))
    w_words, b_words = weight_words(entries)
    offsets, off = region_offsets(
        [("w", w_words), ("b", b_words), ("x", pad4(n_o * p)),
         ("part", pad4(n_o * st)), ("us", pad4(n_o * st)),
         ("ebar", pad4(n_o * st)), ("pool", h1_p),
         ("obuf", 2 * n_o * do_p), ("slot", 2 * half)])
    per_event = off - w_words - b_words - 2 * half
    return Layout(1, n_o, 1, 1, (n_cw + 1) * WARP, st, 2 * half, offsets,
                  off, 4 * per_event, 4 * (off - per_event), design="rows")


def plan_linear(n_objects: int, n_features: int, fr_widths, fo_widths,
                phi_widths, *,
                budget_bytes: int = SMEM_BLOCK_BYTES) -> Layout:
    """B2's launch: the rows design where it fits the budget, else the
    team layout (events per block, pool splits, team, threads); raises
    ``ValueError`` when nothing fits."""
    n_o, p = int(n_objects), int(n_features)
    entries = kernel_entries(p, fr_widths, fo_widths, phi_widths)
    lay = _rows_layout(n_o, p, entries, fr_widths, fo_widths, phi_widths)
    if lay.smem_bytes <= budget_bytes:
        return lay
    h1_p, do_p = entries[0].out_p, pad4(fo_widths[-1])
    mw = pad4(max(max(e.out_p for e in entries), p + fr_widths[-1],
                 fo_widths[-1]))
    team = team_size(mw)
    slot_stride = 2 * mw
    slot_stride += 1 - slot_stride % 2          # odd: conflict-free slots
    w_words, b_words = weight_words(entries)
    epb = max(1, THREADS_TARGET // (n_o * team))
    while True:
        threads = min(-(-(epb * n_o * team) // WARP) * WARP, THREADS_TARGET,
                      MAX_THREADS_PER_BLOCK)
        threads = max(threads, team)
        ks = max(1, min(n_o, threads // (epb * (h1_p // 4))))
        slots = (threads // team) * slot_stride
        offsets, off = region_offsets([
            ("w", w_words), ("b", b_words), ("x", pad4(epb * n_o * p)),
            ("part", epb * ks * h1_p), ("pool", epb * h1_p),
            ("obuf", epb * n_o * do_p), ("osum", epb * do_p),
            ("slot", slots),
        ])
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
    """:func:`plan_linear` for a config and its (raw or quantized) params:
    the launch B2 runs."""
    return plan_linear(cfg.n_objects, cfg.n_features,
                       mlp_widths(params["fr"]), mlp_widths(params["fo"]),
                       mlp_widths(params["phi"]))
