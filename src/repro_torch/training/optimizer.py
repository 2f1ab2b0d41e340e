"""Optimizers as (init, update) function pairs over dict trees.

Port of ``repro.training.optimizer``, with the reference's math step for
step: clip by global norm before the update; AdamW with bias correction
``1 - b^t`` at ``t = step + 1``, ``eps`` added after the ``sqrt`` and the
decay added to the step (not applied to the weights first, as
``torch.optim.AdamW`` does); Adafactor with ``b2t = 1 - t^-decay``,
factored row/col moments for matrix leaves and an RMS-clipped update.

* ``sgd``       — momentum SGD.
* ``adamw``     — decoupled weight decay Adam; fp32 m/v states.
* ``adafactor`` — factored second moments for matrix leaves whose two
  trailing dims are >= ``min_dim_factored``, a full second moment for
  the rest (Shazeer & Stern, arXiv:1804.04235).

``update(grads, state, params, step) -> (params, state, metrics)`` works
in place, under ``torch.no_grad()``: fp32 params and the fp32 state are
rewritten where they lie and returned; a param of another dtype is
updated in fp32 and written back in its own dtype.  The grads are
consumed: fp32 grads are scaled in place by the clip.  ``step`` is the
train state's 0-d int32 tensor, and the learning rate, the bias
corrections and the metrics stay 0-d tensors on the device, so an update
never waits on the card.  AdamW and SGD run as ``torch._foreach_*`` ops
over all leaves: at the ``fm`` width (0.9e9 table values) an unfused
elementwise op would make a 3.6 GB temporary per operation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.common.tree import global_norm, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable    # (grads, state, params, step) -> (new_params, new_state, metrics)
    name: str = ""


def _clip_tree(grads, clip_norm):
    """The grads as fp32, scaled by ``min(1, clip_norm / max(norm,
    1e-12))``, and their global norm before the scaling.  fp32 grads are
    scaled in place; others are copied to fp32 first."""
    gn = global_norm(grads)
    g32 = tree_map(lambda g: g.float(), grads)
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
        torch._foreach_mul_(tree_leaves(g32), scale)
    return g32, gn


def _count(step) -> torch.Tensor:
    """``t = step + 1`` in fp32, on the step's device."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32) + 1.0
    return torch.tensor(step + 1.0, dtype=torch.float32)


def _fp32_views(params):
    """Each param as an fp32 tensor to update: the param itself when it is
    fp32, else an fp32 copy to write back with :func:`_write_back`."""
    return [p if p.dtype == torch.float32 else p.float()
            for p in tree_leaves(params)]


def _write_back(params, p32):
    for p, q in zip(tree_leaves(params), p32):
        if q is not p:
            p.copy_(q)


def sgd(lr_fn, momentum: float = 0.9, clip_norm: Optional[float] = 1.0,
        weight_decay: float = 0.0):
    def init(params):
        return {"mu": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        g32, gn = _clip_tree(grads, clip_norm)
        lr = lr_fn(step)
        mu = tree_leaves(state["mu"])
        torch._foreach_mul_(mu, momentum)
        torch._foreach_add_(mu, tree_leaves(g32))
        p32 = _fp32_views(params)
        upd = torch._foreach_add(mu, p32, alpha=weight_decay)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(p32, upd)
        _write_back(params, p32)
        return params, state, {"grad_norm": gn, "lr": lr}

    return Optimizer(init, update, "sgd")


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, clip_norm: Optional[float] = 1.0):
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        g32, gn = _clip_tree(grads, clip_norm)
        g = tree_leaves(g32)
        lr = lr_fn(step)
        t = _count(step)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        m, v = tree_leaves(state["m"]), tree_leaves(state["v"])
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        del g32, g
        # step_ = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        p32 = _fp32_views(params)
        if weight_decay:
            torch._foreach_add_(upd, p32, alpha=weight_decay)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(p32, upd)
        _write_back(params, p32)
        return params, state, {"grad_norm": gn, "lr": lr}

    return Optimizer(init, update, "adamw")


def adafactor(lr_fn, decay: float = 0.8, eps: float = 1e-30,
              clip_norm: Optional[float] = 1.0, weight_decay: float = 0.0,
              min_dim_factored: int = 128):
    """Factored Adafactor (no momentum), per Shazeer & Stern.

    Matrix leaves with both trailing dims >= min_dim_factored get factored
    row/col accumulators; everything else keeps a full second moment.
    Leading axes (e.g. a stacked layer axis, an expert axis) are kept in
    the factored shapes.
    """

    def _factored(p) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def st(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"r": torch.zeros(p.shape[:-1], **z),          # row
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"acc": tree_map(st, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        g32, gn = _clip_tree(grads, clip_norm)
        lr = lr_fn(step)
        t = _count(step)
        # increasing decay schedule: beta2_t = 1 - t^-decay
        b2t = 1.0 - torch.pow(t, -decay)

        def upd(p, g, acc):
            g2 = g.square() + eps
            if "r" in acc:
                r, c = acc["r"], acc["c"]
                r.copy_(b2t * r + (1 - b2t) * g2.mean(-1))
                c.copy_(b2t * c + (1 - b2t) * g2.mean(-2))
                # v_hat = outer(r, c) / mean(r)
                rmean = r.mean(-1, keepdim=True)
                vhat = (r / torch.clamp(rmean, min=eps))[..., None] \
                    * c[..., None, :]
            else:
                vhat = acc["v"]
                vhat.copy_(b2t * vhat + (1 - b2t) * g2)
            u = g * torch.rsqrt(vhat + eps)
            # update clipping (RMS <= 1), per the paper
            rms = torch.sqrt(u.square().mean() + eps)
            u = u / torch.clamp(rms, min=1.0)
            p32 = p.float()
            p.copy_(p32 - lr * (u + weight_decay * p32))
            return p

        tree_map(upd, params, g32, state["acc"])
        return params, state, {"grad_norm": gn, "lr": lr}

    return Optimizer(init, update, "adafactor")


OPTIMIZERS = {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}


def make_optimizer(name: str, lr_fn, **kw) -> Optimizer:
    return OPTIMIZERS[name](lr_fn, **kw)
