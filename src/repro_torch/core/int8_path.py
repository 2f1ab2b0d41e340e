"""int8 weight-quantized whole-network fused path.

Port of ``repro.core.int8_path``.  Per weight tensor W:
``scale = max(max|W|, 1e-12) / 127``; ``W_q = round(W / scale)`` (half
to even) clipped to [-127, 127] and stored as int8 next to the fp32
scale; biases stay fp32.  The rule is the reference's exactly, so the
same fp32 weights give bit-equal int8 tensors and scales.

The CUDA kernel reads the int8 tensors from device memory as int8,
upcasts them as they land in shared memory, and multiplies each fp32
accumulator by its tensor's scale before the bias — numerically the
dequantized matmul.  The reference fn sees the same quantized params,
so the declared tolerance measures kernel fidelity, not quantization
loss.
"""

from __future__ import annotations

import torch

from repro_torch.core.paths import register_path

#: Engine-vs-ref acceptance bar for the int8 path (fp32 accumulation).
INT8_TOLERANCE = 5e-4


def quantize_params_int8(params):
    """Symmetric per-tensor int8 quantization of every MLP weight; each
    layer becomes ``{"w": int8, "w_scale": fp32 scalar, "b": fp32}``."""
    def qlayer(layer):
        w = layer["w"].float()
        scale = torch.clamp(w.abs().max(), min=1e-12) / 127.0
        wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        out = {"w": wq, "w_scale": scale}
        if "b" in layer:
            out["b"] = layer["b"].float()
        return out

    return {name: {"layers": [qlayer(lp) for lp in mlp["layers"]]}
            for name, mlp in params.items()}


def dequantize_params(qparams):
    """fp32 view of int8-quantized params (``w = w_q * w_scale``)."""
    def dqlayer(layer):
        out = {"w": layer["w"].float() * layer["w_scale"]}
        if "b" in layer:
            out["b"] = layer["b"]
        return out

    return {name: {"layers": [dqlayer(lp) for lp in mlp["layers"]]}
            for name, mlp in qparams.items()}


def _ref_int8(qparams, cfg, x):
    """Reference: strength-reduced forward on the dequantized weights."""
    from repro_torch.core.interaction_net import forward_sr
    return forward_sr(dequantize_params(qparams), cfg, x)


def _bind_int8(qparams, cfg):
    from repro_torch.kernels.fused_jedinet import ops as fused_ops
    return fused_ops.bind_full(qparams, cfg)


def _full_layout(cfg, qparams):
    """The launch B1 runs for these widths (its bucket model)."""
    from repro_torch.kernels.fused_jedinet import autotune
    return autotune.full_layout_for(cfg, qparams)


@register_path(
    name="int8_fused_full",
    ref=_ref_int8,
    fused_level="full",
    cuda=True,
    compute_dtypes=("float32",),      # int8 weights dequantize to fp32 compute
    transform_params=quantize_params_int8,
    bind_params=_bind_int8,
    tolerance=INT8_TOLERANCE,
    quantized=True,
    weight_bytes=1,                   # int8 in device memory, upcast on-chip
    per_sample_bytes=lambda cfg, p: _full_layout(cfg, p).batch_bytes,
    reserved_bytes=lambda cfg, p: _full_layout(cfg, p).reserved_bytes,
    # int8_fused_full -> fused_full -> sr_split
    fallback="fused_full",
    complexity="O(N^2)",
    description="int8-weight whole-network CUDA kernel, on-chip dequant",
)
def forward_int8_fused_full(qparams, cfg, x):
    """Whole-network fused forward with int8 weights dequantized in the
    kernel.  ``qparams`` come from :func:`quantize_params_int8` (the
    spec's transform applies it wherever the path is resolved)."""
    from repro_torch.kernels.fused_jedinet import ops as fused_ops
    return fused_ops.fused_forward_full(qparams, cfg, x)
