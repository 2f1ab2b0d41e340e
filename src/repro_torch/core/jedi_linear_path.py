"""JEDI-linear forward paths: O(N_o) aggregation, registered end to end.

Port of ``repro.core.jedi_linear_path``.  JEDI-linear is a different
model from JEDI-net (the first nonlinearity sees the aggregated
message), so its paths carry their own reference: the O(N_o^2) edge-sum
oracle of the same model (``kernels/jedi_linear/ref.py``), not the
``sr_split`` rung at the bottom of their ladder.  Three paths, one
degradation ladder::

    int8_jedi_linear_full -> jedi_linear_full -> jedi_linear -> sr_split

* ``jedi_linear``           — the O(N_o) pooled forward in plain PyTorch.
* ``jedi_linear_full``      — the whole network in one hand-written CUDA
  kernel per batch (``kernels/csrc/jedi_linear_full.cu``, B2).
* ``int8_jedi_linear_full`` — the same kernel on int8 weights, upcast
  on-chip (scales on the fp32 sums), ``weight_bytes=1``.

Each path's serving bucket ladder comes from the launch B2 runs
(``kernels/jedi_linear/autotune.py``): plain doublings up to
``max_batch`` where its rows design walks the batch one event at a time,
the team layout's tiles where that layout holds (jedi_tracks_128).
"""

from __future__ import annotations

from repro_torch.core.int8_path import (
    INT8_TOLERANCE,
    dequantize_params,
    quantize_params_int8,
)
from repro_torch.core.paths import register_path

#: Engine-vs-ref acceptance bars: the pooled identity is exact in exact
#: arithmetic, so fp32 leaves only summation-order noise; the plain path
#: holds the reference-class bar and the kernel the fused-kernel-class bar.
JEDI_LINEAR_TOLERANCE = 2e-4
JEDI_LINEAR_FUSED_TOLERANCE = 5e-4


def _jedi_flops(cfg, batch):
    """PathSpec.flops_model hook -> :func:`codesign.jedi_linear_flops`
    (imported lazily: codesign pulls in the DSE machinery)."""
    from repro_torch.core.codesign import jedi_linear_flops
    return jedi_linear_flops(cfg, batch)


def _linear_layout(cfg, params):
    from repro_torch.kernels.jedi_linear.autotune import layout_for
    return layout_for(cfg, params)


def _per_sample_bytes(cfg, params):
    """Shared memory one more event of a batch adds to a B2 block (none
    for the rows design, which walks events)."""
    return _linear_layout(cfg, params).batch_bytes


def _reserved_bytes(cfg, params):
    """Shared memory a B2 block spends before its first event."""
    return _linear_layout(cfg, params).reserved_bytes


def _ref_edge_sum(params, cfg, x):
    """Reference: the O(N_o^2) edge-sum oracle of the same model."""
    from repro_torch.kernels.jedi_linear.ref import \
        forward_jedi_linear_edge_sum
    return forward_jedi_linear_edge_sum(params, cfg, x)


def _ref_edge_sum_int8(qparams, cfg, x):
    """Reference for the int8 path: the oracle on dequantized weights, so
    the tolerance measures the kernel, not the quantization."""
    return _ref_edge_sum(dequantize_params(qparams), cfg, x)


def _bind_linear(params, cfg):
    from repro_torch.kernels.jedi_linear import ops as jl_ops
    return jl_ops.bind_linear(params, cfg)


@register_path(
    name="jedi_linear",
    ref=_ref_edge_sum,
    fused_level="edge",
    tolerance=JEDI_LINEAR_TOLERANCE,
    complexity="O(N)",
    flops_model=_jedi_flops,
    per_sample_bytes=_per_sample_bytes,
    reserved_bytes=_reserved_bytes,
    fallback="sr_split",
    description="JEDI-linear O(N) pooled aggregation (torch)",
)
def forward_jedi_linear(params, cfg, x):
    """O(N_o) JEDI-linear forward in plain PyTorch (kernels/jedi_linear)."""
    from repro_torch.kernels.jedi_linear.ref import forward_jedi_linear as fwd
    return fwd(params, cfg, x)


@register_path(
    name="jedi_linear_full",
    ref=_ref_edge_sum,
    fused_level="full",
    cuda=True,
    tolerance=JEDI_LINEAR_FUSED_TOLERANCE,
    bind_params=_bind_linear,
    complexity="O(N)",
    flops_model=_jedi_flops,
    per_sample_bytes=_per_sample_bytes,
    reserved_bytes=_reserved_bytes,
    # a failing kernel demotes to the same model in plain PyTorch first
    fallback="jedi_linear",
    description="JEDI-linear whole-network CUDA kernel, O(N) on-chip",
)
def forward_jedi_linear_full(params, cfg, x):
    """Fused JEDI-linear forward: x -> logits in one CUDA kernel per batch
    (its plain version on CPU tensors)."""
    from repro_torch.kernels.jedi_linear import ops as jl_ops
    return jl_ops.jedi_linear_forward_full(params, cfg, x)


@register_path(
    name="int8_jedi_linear_full",
    ref=_ref_edge_sum_int8,
    fused_level="full",
    cuda=True,
    compute_dtypes=("float32",),      # int8 weights dequantize to fp32 compute
    transform_params=quantize_params_int8,
    bind_params=_bind_linear,
    tolerance=max(JEDI_LINEAR_FUSED_TOLERANCE, INT8_TOLERANCE),
    quantized=True,
    weight_bytes=1,                   # int8 in device memory, upcast on-chip
    complexity="O(N)",
    flops_model=_jedi_flops,
    per_sample_bytes=_per_sample_bytes,
    reserved_bytes=_reserved_bytes,
    fallback="jedi_linear_full",
    description="int8-weight JEDI-linear CUDA kernel, on-chip dequant",
)
def forward_int8_jedi_linear_full(qparams, cfg, x):
    """Fused JEDI-linear forward with int8 weights upcast in the kernel
    (``qparams`` from :func:`quantize_params_int8`, applied by the spec's
    transform wherever the path is resolved)."""
    from repro_torch.kernels.jedi_linear import ops as jl_ops
    return jl_ops.jedi_linear_forward_full(qparams, cfg, x)
