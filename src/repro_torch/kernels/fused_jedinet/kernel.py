"""Fused JEDI-net edge block (x -> Ebar): wrapper and plain version.

Port of ``repro.kernels.fused_jedinet.kernel``.  The TPU kernel
``_edge_block_kernel`` becomes the hand-written CUDA kernel in
``kernels/csrc/fused_jedinet_edge.cu`` (see its header for the designs
and what bounds them): B1's edge stage, stopped at Ebar, which goes to
device memory as (B, N_o, D_e) fp32.  This module holds, side by side:

* :func:`fused_edge_block_kernel_call` — the wrapper.  On a CUDA tensor
  it checks shapes, types and devices, allocates Ebar with
  ``torch.empty`` and launches the design that
  :func:`~repro_torch.kernels.fused_jedinet.autotune.plan_edge` picks on
  the current stream (raising on a non-zero ``cudaError_t``); on a CPU
  tensor it runs the plain version.  It never catches and falls back.
  ``fused_edge_block_kernel_call.launches`` counts the launches.
* :func:`fused_edge_block_plain` — the same function in plain PyTorch,
  with the self-edge masked before the sum and the senders summed in
  the order of the design the kernel runs: the warp design's xor tree
  (:func:`~repro_torch.kernels.fused_jedinet.full_kernel.tree_sender_sum`)
  or the team layout's sender tiles.

The reference sums the full N_o x N_o grid and subtracts the diagonal;
both versions here mask the self-edge before the sum, the same function
with less cancellation.  Weights are fp32 or bf16 (int8 is rejected, as
the reference rejects it: see :func:`~repro_torch.kernels.fused_jedinet.ops.bind_edge`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_jedinet import autotune
from repro_torch.kernels.fused_jedinet import full_kernel as FK
from repro_torch.nn.core import ACTIVATIONS

LIB_NAME = "fused_jedinet_edge"
SOURCES = ("fused_jedinet_edge.cu",)


def fused_edge_block_plain(x, fr_arrays, *, activation: str,
                           block_s: int | None = None):
    """The kernel's function in plain PyTorch. x: (B, N_o, P) -> Ebar
    (B, N_o, D_e) fp32.  ``fr_arrays = [w1r, w1s, b1, w2, b2, ...]``;
    ``x.dtype`` is the compute dtype; the senders are summed in the
    order of the design :func:`~repro_torch.kernels.fused_jedinet.autotune.plan_edge`
    picks for these widths and ``block_s``: the warp design's tree, or
    the team layout's sender tiles of ``block_s`` (all at once by
    default)."""
    n_weights = 2 + (len(fr_arrays) - 3) // 2
    fr_w = [int(fr_arrays[0].shape[-1])] + [int(w.shape[-1])
                                            for w in fr_arrays[3::2]]
    design = autotune.plan_edge(x.shape[1], x.shape[2], fr_w,
                                block_s=block_s).design
    return FK.edge_sum_plain(x.float(), fr_arrays, [None] * n_weights,
                             ACTIVATIONS[activation],
                             x.dtype == torch.bfloat16, block_s,
                             order=FK.SUM_ORDERS[design])


def fused_edge_block_kernel_call(x: torch.Tensor,
                                 weights: FK.KernelWeights, *,
                                 activation: str,
                                 block_s: int | None = None):
    """x: (B, N_o, P) fp32 or bf16 (the compute dtype) -> Ebar (B, N_o,
    D_e) fp32.

    ``weights`` hold f_R alone (``fo`` and ``phi`` empty) in fp32 or
    bf16.  CUDA tensors launch the kernel in the design
    :func:`~repro_torch.kernels.fused_jedinet.autotune.plan_edge` picks
    (no batch padding: the warp design walks events, the team layout
    masks its ragged last block); CPU tensors run
    :func:`fused_edge_block_plain`.  ``block_s`` pins the team layout's
    sender tile (default: the planner's design and tile).  Raises on what
    the kernel does not take.
    """
    if weights.fo or weights.phi or weights.scales is not None:
        raise ValueError("the edge-block kernel takes f_R's fp32 or bf16 "
                         "weights alone (no f_O / phi_O, no int8)")
    if FK.runs_plain(x, weights, activation):
        return fused_edge_block_plain(x, weights.fr, activation=activation,
                                      block_s=block_s)
    weights.pack()
    n_o = x.shape[1]
    header = weights.launch_header(
        ("edge", n_o, block_s),
        lambda: autotune.plan_edge(n_o, weights.n_features,
                                   weights.widths()[0], block_s=block_s),
        n_o, 0)
    out = torch.empty((x.shape[0], n_o, header[1]["d_e"]),
                      dtype=torch.float32, device=x.device)
    symbol = "jedi_edge_block_warp" if header[0].design == "warp" \
        else "jedi_edge_block"
    FK.launch(FK.load_launcher(LIB_NAME, SOURCES, symbol), symbol, x,
              weights, out, header, activation)
    fused_edge_block_kernel_call.launches += 1
    return out


fused_edge_block_kernel_call.launches = 0
