"""Train-step builder with gradient accumulation, port of
``repro.training.trainer``.

``make_train_step(loss_fn, optimizer)`` returns
``step(state, batch) -> (state, metrics)``.  The forward and backward run
in plain PyTorch autograd (the reference runs them in XLA; no kernel of
the port has a backward), the grads are cast to fp32 and the optimizer
updates the params and its state in place.

* **Gradient accumulation** — ``grad_accum > 1`` splits the batch's
  leading axis into micro-batches and loops over them, summing the
  grads and the loss and then dividing by ``grad_accum``; each metric is
  the mean over the micro-batches, as the reference's ``lax.scan`` gives.
* **Metrics stay on the device** as 0-d tensors; only the caller turns
  them into floats (the train CLI does so on log steps alone).
* **Sharded states** — with ``DTensor`` params (placed by
  ``parallel.sharding.distribute`` and stepped inside an ``axis_rules``
  context) each grad is redistributed to its param's placements as soon
  as autograd returns it: a replicated param's ``Partial`` grad is
  all-reduced, a sharded one's reduce-scattered, which is the
  data-parallel reduction XLA inserts where the reference's grads meet
  their params' shardings.  The optimizer then sees reduced grads.

The trainer state is a plain dict ``{"params", "opt", "step"}``, with the
step a 0-d int32 tensor on the params' device, so the checkpoint module
saves it without special cases.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.training.optimizer import Optimizer


def _like(g, p):
    """``g`` with ``p``'s placements when ``p`` is a ``DTensor``."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def init_state(seed, init_params_fn: Callable, optimizer: Optimizer):
    params = init_params_fn(seed)
    device = tree_leaves(params)[0].device
    return {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    grad_accum: int = 1):
    """loss_fn(params, batch) -> (scalar loss, metrics dict)."""

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        grads = tree_unflatten(params, [_like(g.float(), p)
                                        for g, p in zip(grads, leaves)])
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def step(state, batch):
        params = state["params"]
        if grad_accum == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads, loss, per_micro = None, 0.0, []
            for i in range(grad_accum):
                l_i, m_i, g_i = grads_of(params, {k: v[i]
                                                  for k, v in micro.items()})
                grads = g_i if grads is None else tree_map(
                    torch.Tensor.add_, grads, g_i)
                loss = loss + l_i
                per_micro.append(m_i)
            grads = tree_map(lambda g: g.div_(grad_accum), grads)
            loss = loss / grad_accum
            metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                       for k in per_micro[0]}

        new_params, new_opt, opt_metrics = optimizer.update(
            grads, state["opt"], params, state["step"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return step
