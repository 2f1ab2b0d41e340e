"""Whole-network fused JEDI-linear forward (x -> logits): wrapper and plain
version.

Port of ``repro.kernels.jedi_linear.linear_kernel``.  The TPU kernel
``_linear_forward_kernel`` becomes the hand-written CUDA kernel in
``kernels/csrc/jedi_linear_full.cu`` (see its header for the design and
what bounds it).  This module holds, side by side:

* :func:`jedi_linear_kernel_call` — the wrapper.  On a CUDA tensor it
  checks shapes, types and devices, allocates the logits with
  ``torch.empty`` and launches the kernel on the current stream (raising
  on a non-zero ``cudaError_t``); on a CPU tensor it runs the plain
  version.  It never catches and falls back.
  ``jedi_linear_kernel_call.launches`` counts the launches.
* :func:`jedi_linear_forward_full_plain` — the same function in plain
  PyTorch, step for step as the reference kernel computes it.

The plain version follows the kernel's summation orders, so that the
comparison on the card is tight: the pool in the order of the design
:func:`~repro_torch.kernels.jedi_linear.autotune.plan_linear` picks (the
rows design's xor tree over the nodes, or the team layout's node
splits), the recombination rounded step by step, and the node sum in
node order (``FK.readout_plain``, shared with B1, whose readout warp
sums the same way).  The (N_o - 1)-fold recombination makes a one-ulp
difference in the pool visible through the bf16 rounding of the next
layer's operands: with the pool in another order than the kernel's, the
bf16 gap between kernel and plain version was 5.80e-4 of the logit scale
at jedi_30p on an H100; in the kernel's order it is 1.94e-8 (jedi_30p,
bf16, B = 257, both designs), against 1e-3 allowed.

The weights are B1's :class:`~repro_torch.kernels.fused_jedinet.full_kernel.KernelWeights`
(the same split and packed buffers).  Precision: ``x.dtype`` is the
compute dtype; every operand of a product is rounded to it, while u_r,
u_s, the pool, the recombination, every bias and every sum stay fp32
(the reference kernel's rule, which differs from the plain
``jedi_linear`` path's bf16 biases: the two are not unified).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_jedinet import full_kernel as FK
from repro_torch.kernels.jedi_linear import autotune
from repro_torch.nn.core import ACTIVATIONS

LIB_NAME = "jedi_linear_full"
SOURCES = ("jedi_linear_full.cu",)


def _pool(u_s, lay):
    """Sum of ``u_s`` (B, N_o, H1) over the nodes, (B, 1, H1), in the
    order of the kernel's design ``lay``: the rows design's lanes (lane l
    adds nodes l, l + 32, ... in ascending order) then the xor tree; the
    team layout's splits (split ``s`` of ``ks`` adds nodes s, s + ks, ...
    one by one, then the splits are added in order)."""
    if lay.design == "rows":
        return FK.tree_sender_sum(u_s[:, None])
    ks = lay.ks
    total = torch.zeros_like(u_s[:, 0])
    for k in range(ks):
        part = torch.zeros_like(total)
        for j in range(k, u_s.shape[1], ks):
            part = part + u_s[:, j]
        total = total + part
    return total[:, None, :]


def jedi_linear_forward_full_plain(x, fr_arrays, fo_arrays, phi_arrays, *,
                                   activation: str, scales=None):
    """The kernel's function in plain PyTorch. x: (B, N_o, P) -> (B, T) fp32.

    ``fr_arrays = [w1r, w1s, b1, w2, b2, ...]``; ``scales`` one fp32
    scalar per weight tensor ``[w1r, w1s, w2.., fo.., phi..]`` for int8
    weights (w1's halves share w1's scale), else None.  The pool sums in
    the kernel's order (:func:`_pool`).
    """
    bf16 = x.dtype == torch.bfloat16
    act = ACTIVATIONS[activation]
    n_fr_w = 2 + (len(fr_arrays) - 3) // 2        # w1r, w1s, w2, ...
    n_fo = len(fo_arrays) // 2
    s = FK.plain_scales(scales, n_fr_w + n_fo + len(phi_arrays) // 2)
    w1r, w1s, b1, rest = fr_arrays[0], fr_arrays[1], fr_arrays[2], \
        fr_arrays[3:]
    xf = x.float()
    n_o = x.shape[1]
    widths = ([int(w1r.shape[-1])] + [int(w.shape[-1]) for w in rest[::2]],
              [int(w.shape[-1]) for w in fo_arrays[::2]],
              [int(w.shape[-1]) for w in phi_arrays[::2]])
    lay = autotune.plan_linear(n_o, x.shape[2], *widths)
    # f_R layer 1, pooled: two per-node projections, one pool, the
    # per-node recombination; all fp32
    u_r = FK.mmq(xf, w1r, s[0], bf16)                       # (B, N_o, H1)
    u_s = FK.mmq(xf, w1s, s[1], bf16)                       # (B, N_o, H1)
    pooled = _pool(u_s, lay)                                 # (B, 1, H1)
    h = (n_o - 1) * (u_r + b1.float()) + (pooled - u_s)
    # the remaining f_R layers per node (the first output is linear)
    if rest:
        h = FK.mlp_plain(act(h), rest, s[2:n_fr_w], act, bf16)
    # C = [x ‖ Ebar], f_O, the node sum, phi_O
    return FK.readout_plain(xf, h, fo_arrays, phi_arrays,
                            s[n_fr_w:n_fr_w + n_fo], s[n_fr_w + n_fo:], act,
                            bf16)


def jedi_linear_kernel_call(x: torch.Tensor, weights: FK.KernelWeights, *,
                            activation: str, n_targets: int):
    """x: (B, N_o, P) fp32 or bf16 (the compute dtype) -> logits (B, T) fp32.

    CUDA tensors launch the kernel in the design
    :func:`~repro_torch.kernels.jedi_linear.autotune.plan_linear` picks
    (no batch padding: the rows design walks events, the team layout
    masks its ragged last block); CPU tensors run
    :func:`jedi_linear_forward_full_plain`.  Raises on shapes, types or
    devices the kernel does not take.
    """
    if FK.runs_plain(x, weights, activation):
        return jedi_linear_forward_full_plain(
            x, weights.fr, weights.fo, weights.phi, activation=activation,
            scales=weights.scales)
    weights.pack()
    n_o = x.shape[1]
    header = weights.launch_header(
        ("linear", n_o, n_targets),
        lambda: autotune.plan_linear(n_o, weights.n_features,
                                     *weights.widths()),
        n_o, n_targets)
    out = torch.empty((x.shape[0], n_targets), dtype=torch.float32,
                      device=x.device)
    symbol = "jedi_linear_full_rows" if header[0].design == "rows" \
        else "jedi_linear_full"
    FK.launch(FK.load_launcher(LIB_NAME, SOURCES, symbol), symbol, x,
              weights, out, header, activation)
    jedi_linear_kernel_call.launches += 1
    return out


jedi_linear_kernel_call.launches = 0
