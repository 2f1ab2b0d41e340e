"""Public entries of the fused JEDI-net kernels.

Port of ``repro.kernels.fused_jedinet.ops``.  Two entry points:

* :func:`fused_edge_block` — edge-only fusion (kernel B3): x -> Ebar;
  f_O / phi_O follow in plain PyTorch (``interaction_net.forward_fused``).
* :func:`fused_forward_full` — whole-network fusion (kernel B1): x ->
  logits in one kernel.

:func:`bind_full` / :func:`bind_edge` do the per-weights work once —
split f_R's first layer, flatten the MLPs, gather the int8 scales and
pack everything for the kernel — and the entry points cast x to the
compute dtype and launch.  The batch is not padded: the kernels mask
their ragged last block, so results come back with exactly the batch's
rows.

int8-quantized params (layers carrying ``"w_scale"``, see
``core/int8_path.py``) keep their int8 weights all the way into the
kernel, which upcasts them on-chip.
"""

from __future__ import annotations

from repro_torch.kernels.fused_jedinet import full_kernel as FK
from repro_torch.kernels.fused_jedinet import kernel as K
from repro_torch.nn.core import as_dtype


def is_quantized_params(params) -> bool:
    """True when the MLP layers carry int8 weights + dequant scales.

    Quantization is all-or-nothing: a mixed pytree is rejected here at
    the boundary instead of failing opaquely inside the kernel.
    """
    flags = [("w_scale" in lp)
             for mlp in params.values() for lp in mlp["layers"]]
    if any(flags) and not all(flags):
        raise ValueError(
            "partially quantized params: every MLP layer must carry "
            "'w_scale' (quantize_params_int8 quantizes all layers); "
            "mixed fp32/int8 pytrees are not supported")
    return all(flags) and bool(flags)


def bind_full(params, cfg) -> FK.KernelWeights:
    """Split, flatten, gather scales and (on a CUDA device) pack, once."""
    cdt = as_dtype(cfg.compute_dtype)
    quantized = is_quantized_params(params)
    w1r, w1s, b1, rest = FK.split_first_layer(params["fr"], cfg.n_features,
                                              dtype=cdt)
    scales = None
    if quantized:
        s_fr = FK.mlp_scales(params["fr"])
        # w1 splits into (w1r, w1s): both halves share w1's tensor scale
        scales = [s_fr[0], s_fr[0], *s_fr[1:],
                  *FK.mlp_scales(params["fo"]), *FK.mlp_scales(params["phi"])]
    bound = FK.KernelWeights(
        fr=[w1r, w1s, b1, *rest], fo=FK.flatten_mlp(params["fo"], cdt),
        phi=FK.flatten_mlp(params["phi"], cdt), scales=scales,
        n_features=cfg.n_features)
    if bound.device.type == "cuda":
        bound.pack()
    return bound


def fused_forward_full(params, cfg, x, *, block_s: int | None = None):
    """Whole-network fused forward. x: (B, N_o, P) -> logits (B, n_targets).

    ``params`` are raw (fp32 / int8-quantized) MLP params or the
    :class:`~repro_torch.kernels.fused_jedinet.full_kernel.KernelWeights`
    from :func:`bind_full`.  ``block_s`` pins the
    sender tile (tests); by default the autotuner picks it.
    """
    bound = params if isinstance(params, FK.KernelWeights) \
        else bind_full(params, cfg)
    x = x.to(as_dtype(cfg.compute_dtype)).contiguous()
    return FK.fused_forward_full_kernel_call(
        x, bound, activation=cfg.activation, n_targets=cfg.n_targets,
        block_s=block_s)


def bind_edge(params_fr, cfg) -> FK.KernelWeights:
    """f_R split and (on a CUDA device) packed for the edge-block kernel,
    once.  int8-quantized f_R is rejected, as the reference rejects it:
    the edge kernel has no dequant-scale plumbing."""
    if any("w_scale" in lp for lp in params_fr["layers"]):
        raise ValueError(
            "fused_edge_block does not support int8-quantized params; "
            "serve quantized weights through fused_forward_full "
            "(on-chip dequant) or dequantize_params first")
    w1r, w1s, b1, rest = FK.split_first_layer(
        params_fr, cfg.n_features, dtype=as_dtype(cfg.compute_dtype))
    bound = FK.KernelWeights(fr=[w1r, w1s, b1, *rest], fo=[], phi=[],
                             scales=None, n_features=cfg.n_features)
    if bound.device.type == "cuda":
        bound.pack()
    return bound


def fused_edge_block(params_fr, cfg, x, *, block_s: int | None = None):
    """Ebar = aggregated f_R messages. x: (B, N_o, P) -> (B, N_o, D_e) fp32.

    ``params_fr`` is f_R's raw params or the bound form from
    :func:`bind_edge`; ``block_s`` pins the sender tile (tests)."""
    bound = params_fr if isinstance(params_fr, FK.KernelWeights) \
        else bind_edge(params_fr, cfg)
    x = x.to(as_dtype(cfg.compute_dtype)).contiguous()
    return K.fused_edge_block_kernel_call(
        x, bound, activation=cfg.activation, block_s=block_s)
