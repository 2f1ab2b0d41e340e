"""Carry parameter pytrees between the JAX reference and the port.

``jax.random`` initialisation cannot be replayed in torch, so the
parity tests initialise once on the JAX side, convert the pytree to
numpy, and hand it here.  The layout is kept as it is: a Linear is
``{"w": (in, out), "b": (out,)}`` multiplied as ``x @ w``; int8 ``w``
and the scalar fp32 ``w_scale`` of quantized layers stay as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_jax(tree, *, device="cuda"):
    """A JAX param pytree of numpy-convertible leaves — e.g. ``{"fr"|"fo"|
    "phi": {"layers": [{"w","b"[,"w_scale"]}]}}`` or one MLP's
    ``{"layers": [...]}`` — as the same structure of torch tensors on
    ``device``, dtypes unchanged (fp32 stays fp32, int8 stays int8)."""
    dev = resolve_device(device)
    return _map(tree, lambda leaf: torch.from_numpy(
        np.array(np.asarray(leaf), copy=True)).to(dev))


def params_to_numpy(params):
    """The inverse of :func:`params_from_jax`: torch leaves -> numpy."""
    return _map(params, lambda t: t.detach().cpu().numpy())
