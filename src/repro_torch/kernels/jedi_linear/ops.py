"""Public entry of the fused JEDI-linear kernel (B2).

Port of ``repro.kernels.jedi_linear.ops``.  :func:`bind_linear` does the
per-weights work once — split f_R's first layer, flatten the MLPs,
gather the int8 scales (w1's halves share w1's scale) and pack — into
the same buffers kernel B1 reads; :func:`jedi_linear_forward_full` casts
x to the compute dtype and launches.  The batch is not padded: the
kernel masks its ragged last block.  int8-quantized params keep their
int8 weights all the way into the kernel, which upcasts them on-chip.
"""

from __future__ import annotations

from repro_torch.kernels.fused_jedinet import full_kernel as FK
from repro_torch.kernels.fused_jedinet import ops as fused_ops
from repro_torch.kernels.jedi_linear import linear_kernel as LK
from repro_torch.nn.core import as_dtype

#: B2 reads B1's packed weights: the binding is the same.
bind_linear = fused_ops.bind_full


def jedi_linear_forward_full(params, cfg, x):
    """Fused JEDI-linear forward. x: (B, N_o, P) -> logits (B, n_targets).

    ``params`` are raw (fp32 / int8-quantized) MLP params or the
    :class:`~repro_torch.kernels.fused_jedinet.full_kernel.KernelWeights`
    from :func:`bind_linear`.
    """
    bound = params if isinstance(params, FK.KernelWeights) \
        else bind_linear(params, cfg)
    x = x.to(as_dtype(cfg.compute_dtype)).contiguous()
    return LK.jedi_linear_kernel_call(
        x, bound, activation=cfg.activation, n_targets=cfg.n_targets)
