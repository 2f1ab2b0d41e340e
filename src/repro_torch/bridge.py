"""Carry parameter pytrees between the JAX reference and the port.

``jax.random`` initialisation cannot be replayed in torch, so the
parity tests initialise once on the JAX side, convert the pytree to
numpy, and hand it here.  The layout is kept as it is: a Linear is
``{"w": (in, out), "b": (out,)}`` multiplied as ``x @ w``; int8 ``w``
and the scalar fp32 ``w_scale`` of quantized layers stay as they are;
bf16 leaves (``ml_dtypes.bfloat16`` in numpy, e.g. arctic-480b's
``param_dtype``) become bf16 tensors bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import tree_map


def _tensor(leaf) -> torch.Tensor:
    a = np.array(np.asarray(leaf), copy=True)
    if a.dtype.name == "bfloat16":               # numpy has no bf16 of its own
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, *, device="cuda"):
    """A JAX param pytree of numpy-convertible leaves — e.g. ``{"fr"|"fo"|
    "phi": {"layers": [{"w","b"[,"w_scale"]}]}}`` or one MLP's
    ``{"layers": [...]}`` — as the same structure of torch tensors on
    ``device``, dtypes unchanged (fp32 stays fp32, int8 stays int8, bf16
    stays bf16)."""
    dev = resolve_device(device)
    return tree_map(lambda leaf: _tensor(leaf).to(dev), tree)


def params_to_numpy(params):
    """The inverse of :func:`params_from_jax`: torch leaves -> numpy."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def state_from_jax(state, *, device="cuda"):
    """A JAX train state ``{"params", "opt", "step"}`` (as made by
    ``repro.training.init_state`` or restored by ``repro.checkpoint``) as
    the port's: every leaf a tensor on ``device`` in its own dtype, the
    optimizer's leaves wherever they sit (AdamW's ``m`` / ``v``,
    Adafactor's ``{r, c}`` or ``{v}`` per param), and the step a 0-d
    int32 tensor, so both trainers can start from one state."""
    if set(state) != {"params", "opt", "step"}:
        raise ValueError(f"a train state has params, opt and step, not "
                         f"{sorted(state)}")
    out = params_from_jax(state, device=device)
    out["step"] = out["step"].to(torch.int32).reshape(())
    return out


def state_to_numpy(state):
    """The inverse of :func:`state_from_jax`: every leaf as numpy."""
    return params_to_numpy(state)
