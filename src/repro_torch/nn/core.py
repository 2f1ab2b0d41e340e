"""Minimal NN substrate: linear, MLP, RMSNorm and LayerNorm as functions
over dict pytrees.

Port of ``repro.nn.core``.  A Linear is ``{"w": (in, out), "b": (out,)}``
and is applied as ``x @ w + b`` on the last axis; parameters are stored
in fp32 and cast to ``compute_dtype`` at use.

bf16 rounds where the JAX reference rounds: a product of bf16 operands
is taken exactly in fp32 and rounded once to bf16 (:func:`matmul`), the
bias is cast to bf16 and the add rounds again.  ``jax.nn.gelu`` is the
tanh approximation, so ``gelu`` here is ``F.gelu(approximate="tanh")``.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.common import prng
from repro_torch.parallel.sharding import flatten_ready

ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "silu": F.silu,
    "selu": F.selu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


def as_dtype(dtype) -> torch.dtype | None:
    """``"float32"`` / ``"bfloat16"`` / a torch dtype / None -> torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' dtype, bf16 the way XLA takes it: exact
    products, fp32 accumulation, one rounding of the result to bf16."""
    if a.dtype == torch.bfloat16 or b.dtype == torch.bfloat16:
        return (a.float() @ b.float()).to(torch.bfloat16)
    return a @ b


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (batched over leading axes too) in the operands' dtype,
    bf16 with exact products, fp32 sums and one rounding of the result:
    the LM's product helper at full width.

    :func:`matmul` takes a bf16 product as ``(a.float() @
    b.float()).to(bf16)``, which at an LM's width would copy its weights
    to fp32 on every decode step and run fp32 GEMMs.  On the card bf16
    ``torch.matmul`` computes the same function (cuBLAS, fp32
    accumulation, reduced-precision reduction off inside
    ``models.transformer.xla_rounding``).  On the CPU, where torch's bf16
    GEMM may round partial sums, :func:`matmul` keeps the reference's
    rounding; the JEDI paths keep :func:`matmul` everywhere.

    A sharded ``x`` (a ``DTensor``), and the grad of the result, keep at
    most their first leading axis sharded
    (``parallel.sharding.flatten_ready``): the product and its backward
    flatten the leading axes.
    """
    x = flatten_ready(x, 0, x.dim() - 2)
    y = torch.matmul(x, w) if x.is_cuda else matmul(x, w)
    return flatten_ready(y, 0, y.dim() - 2)


def sum_upcast(x: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.sum``: bf16 inputs are summed in fp32, then rounded back."""
    if x.dtype == torch.bfloat16:
        return x.float().sum(dim).to(torch.bfloat16)
    return x.sum(dim)


def normal(source, shape) -> torch.Tensor:
    """Standard normal fp32 draws on the CPU from a ``torch.Generator``, or
    from a key of :mod:`repro_torch.common.prng` (the reference's
    ``jax.random.normal``, each draw within 3 ulps)."""
    if isinstance(source, torch.Generator):
        return torch.randn(shape, generator=source, dtype=torch.float32)
    return prng.normal(source, shape)


def dense_init(generator, in_dim: int, out_dim: int, *,
               dtype=torch.float32, scale: str = "fan_in",
               use_bias: bool = True, device="cuda"):
    """He/LeCun-style variance-scaling init, drawn on the CPU from
    ``generator`` (a ``torch.Generator`` or a ``prng`` key) and moved to
    ``device`` (the card by default; raises without one)."""
    dev = resolve_device(device)
    if scale == "fan_in":
        std = math.sqrt(2.0 / in_dim)
    elif scale == "lecun":
        std = math.sqrt(1.0 / in_dim)
    elif scale == "fan_avg":
        std = math.sqrt(2.0 / (in_dim + out_dim))
    else:
        raise ValueError(f"unknown init scale {scale}")
    w = normal(generator, (in_dim, out_dim)) * std
    p = {"w": w.to(dtype=as_dtype(dtype), device=dev)}
    if use_bias:
        p["b"] = torch.zeros((out_dim,), dtype=as_dtype(dtype), device=dev)
    return p


def dense_apply(p, x, *, compute_dtype=None):
    cdt = as_dtype(compute_dtype)
    w = p["w"]
    if cdt is not None:
        w = w.to(cdt)
        x = x.to(cdt)
    y = matmul(x, w)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def mlp_dims(in_dim: int, hidden: Sequence[int], out_dim: int) -> list:
    """Layer (in, out) dims for an MLP with the given hidden sizes."""
    dims = [in_dim, *hidden, out_dim]
    return list(zip(dims[:-1], dims[1:]))


def split_source(source, n: int) -> list:
    """``n`` sources of draws: a ``prng`` key split as
    ``jax.random.split(key, n)``, or one ``torch.Generator`` (an int seeds
    a new one) drawn from in turn."""
    if isinstance(source, torch.Generator):
        return [source] * n
    if isinstance(source, int):
        return [torch.Generator().manual_seed(source)] * n
    return prng.split(source, n)


def mlp_init(generator, in_dim: int, hidden: Sequence[int],
             out_dim: int, *, dtype=torch.float32, scale: str = "fan_in",
             device="cuda"):
    """An MLP's layers from one ``torch.Generator`` drawn in turn, or from
    a ``prng`` key split per layer as the reference splits its key."""
    dims = mlp_dims(in_dim, hidden, out_dim)
    sources = split_source(generator, len(dims))
    return {"layers": [dense_init(src, din, dout, dtype=dtype, scale=scale,
                                  device=device)
                       for src, (din, dout) in zip(sources, dims)]}


def mlp_apply(p, x, *, activation: str = "relu",
              final_activation: str = "identity", compute_dtype=None):
    """Apply an MLP: activation between layers, `final_activation` at the end."""
    act = ACTIVATIONS[activation]
    fact = ACTIVATIONS[final_activation]
    layers = p["layers"]
    for i, lp in enumerate(layers):
        x = dense_apply(lp, x, compute_dtype=compute_dtype)
        x = act(x) if i < len(layers) - 1 else fact(x)
    return x


def rmsnorm_init(dim: int, *, dtype=torch.float32, device="cuda"):
    return {"scale": torch.ones((dim,), dtype=as_dtype(dtype),
                                device=resolve_device(device))}


def rmsnorm_apply(p, x, *, eps: float = 1e-6):
    """RMSNorm over the last axis: statistics and scaling in fp32, the
    result in x's dtype (one rounding, as the reference)."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(dim: int, *, dtype=torch.float32, device="cuda"):
    dev = resolve_device(device)
    return {"scale": torch.ones((dim,), dtype=as_dtype(dtype), device=dev),
            "bias": torch.zeros((dim,), dtype=as_dtype(dtype), device=dev)}


def layernorm_apply(p, x, *, eps: float = 1e-5):
    """LayerNorm over the last axis in fp32, the result in x's dtype.  The
    variance is the population variance, as ``jnp.var`` takes it
    (``torch.var`` divides by n - 1 unless given ``correction=0``)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)
