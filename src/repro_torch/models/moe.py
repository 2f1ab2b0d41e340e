"""Mixture-of-Experts layer: sort-based top-k dispatch with capacity.

Port of ``repro.models.moe`` with its semantics:

* **routing** — the router product in the compute dtype, cast to fp32,
  softmax, top-k, gates renormalised by ``max(sum, 1e-9)``.  The top-k
  is a stable descending sort, so of two tied probabilities the lower
  expert index wins, as ``jax.lax.top_k`` breaks ties (``torch.topk``
  promises no order; bf16 router logits tie often);
* **Switch aux loss** — ``aux_loss_weight * E * sum(mean probs * top-1
  share)``;
* **dispatch** — assignments stable-sorted by expert, position = index
  minus the first occurrence (``searchsorted``, left), kept while
  ``pos < capacity``; dropped ones go to the sentinel row ``E * c`` of an
  ``(E * c + 1, d)`` buffer (the only row that receives duplicate
  indices, and it is discarded);
* **experts** — the batched SwiGLU over all ``E x c`` rows, whatever the
  routing;
* **combine** — each assignment's output row gathered back to its
  ``(token, k)`` place, times its gate in y's dtype, in fp32, summed over
  k in k order (``sum(1)``, no float atomics); the reference's XLA
  scatter-add sums the same terms in expert order, so the two differ in
  summation order only.  The output is cast to the compute dtype.

Nothing here reads a value back to the host: the capacity comes from the
token count of the call (a shape), so a decode step at 16 slots computes
512 expert rows for its 96 assignments, and a padded prefill's pad
tokens enter the MoE and compete for slots after the real tokens, as in
the reference.  The products go through :func:`repro_torch.nn.core.dot`
(the reference leaves them to XLA; the MoE has no Pallas kernel).  The
reference's six sharding constraints are in place
(:func:`repro_torch.parallel.sharding.constrain`): no-ops outside an
``axis_rules`` context.  The all-to-all dispatch across ranks is
``parallel/moe_dispatch.py``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import resolve_device
from repro_torch.common import prng
from repro_torch.configs.base import MoEConfig
from repro_torch.nn import core as nn
from repro_torch.parallel.sharding import constrain, on_whole, \
    split_reshape


def moe_shapes(moe: MoEConfig, d_model: int, d_ff: int) -> dict:
    """``(group, name) -> (key index, shape, std)`` of one layer's MoE
    weights: the index into the reference's ``split(key, 5)``."""
    e = moe.n_experts
    std_in = (2.0 / d_model) ** 0.5
    std_out = (2.0 / d_ff) ** 0.5
    return {
        ("router", "w"): (0, (d_model, e), std_in),
        ("experts", "w_gate"): (1, (e, d_model, d_ff), std_in),
        ("experts", "w_in"): (2, (e, d_model, d_ff), std_in),
        ("experts", "w_out"): (3, (e, d_ff, d_model), std_out),
    }


def init_moe(key, moe: MoEConfig, d_model: int, d_ff: int, *,
             dtype=torch.float32, device="cuda"):
    """One layer's MoE params on ``device`` from a ``prng`` key: the
    reference's ``init_moe(key, ...)``, each weight within a few ulps
    (``split(key, 5)``, ``ks[0..3]`` for the router and the experts'
    ``w_gate`` / ``w_in`` / ``w_out``).  ``models.transformer.init(int)``
    draws the same shapes and scales with torch on the card."""
    ks = prng.split(key, 5)
    dev, pd = resolve_device(device), nn.as_dtype(dtype)
    params = {"router": {}, "experts": {}}
    for (group, name), (i, shape, std) in moe_shapes(
            moe, d_model, d_ff).items():
        params[group][name] = (prng.normal(ks[i], shape) * std).to(
            dtype=pd, device=dev)
    return params


def capacity(n_tokens: int, moe: MoEConfig) -> int:
    c = int(n_tokens * moe.top_k * moe.capacity_factor / moe.n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8 for tiling


def route(params, moe: MoEConfig, x, *, compute_dtype=torch.bfloat16):
    """x: (T, d) -> (probs (T, E) fp32, gates (T, k) fp32, expert ids
    (T, k) int64): the router product in the compute dtype, cast to fp32,
    softmax, and the top k by a stable descending sort (ties to the lower
    expert index), gates renormalised."""
    cdt = nn.as_dtype(compute_dtype)
    logits = nn.dot(x.to(cdt), params["router"]["w"].to(cdt)).float()
    probs = torch.softmax(logits, dim=-1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :moe.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, ids[:, :moe.top_k]


def dispatch_slots(expert_ids, moe: MoEConfig, c: int):
    """(T, k) expert ids -> (T * k,) buffer row of each assignment in
    (token, k) order: ``expert * c + position`` for the first ``c`` of
    each expert in priority order (token-major, then k), else the
    sentinel ``E * c``.  Sharded ids are gathered whole first
    (``parallel.sharding.on_whole``: DTensor has no rule for
    ``searchsorted``)."""
    return on_whole(functools.partial(_dispatch_slots, moe=moe, c=c),
                    expert_ids)


def _dispatch_slots(expert_ids, moe: MoEConfig, c: int):
    e = moe.n_experts
    flat_e = expert_ids.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(flat_e.numel(), device=flat_e.device) - first
    slot_sorted = torch.where(pos < c, sorted_e * c + pos, e * c)
    return torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)


def moe_apply(params, moe: MoEConfig, x, *, compute_dtype=torch.bfloat16,
              activation: str = "silu"):
    """x: (T, d) token-major. Returns (out (T, d) in the compute dtype,
    aux_loss fp32 scalar)."""
    t, d = x.shape
    e, k = moe.n_experts, moe.top_k
    c = capacity(t, moe)
    cdt = nn.as_dtype(compute_dtype)
    act = nn.ACTIVATIONS[activation]

    xc = x.to(cdt)
    probs, gates, expert_ids = route(params, moe, xc, compute_dtype=cdt)

    # --- load-balancing auxiliary loss (Switch eq. 4) ---
    experts = torch.arange(e, device=x.device)
    top1 = (expert_ids[:, :1] == experts).float()              # (T, E)
    aux = moe.aux_loss_weight * e * (probs.mean(0) * top1.mean(0)).sum()

    # --- sort-based dispatch ---
    slot = dispatch_slots(expert_ids, moe, c)                  # (T*k,)
    dispatched = constrain(split_reshape(xc[:, None].expand(t, k, d),
                                         (t * k, d), 0, t), "tokens", None)
    buf = xc.new_zeros((e * c + 1, d)).index_copy(0, slot, dispatched)
    h = constrain(buf[:e * c].view(e, c, d), "expert", "expert_slot", None)

    # --- per-expert SwiGLU ---
    w = params["experts"]
    hg = nn.dot(h, w["w_gate"].to(cdt))
    hi = nn.dot(h, w["w_in"].to(cdt))
    hmid = constrain(act(hg) * hi, "expert", "expert_slot", "mlp")
    y = nn.dot(hmid, w["w_out"].to(cdt))                       # (E, c, d)
    y = constrain(y, "expert", "expert_slot", None)

    # --- combine: the sentinel row gathers zeros ---
    y_flat = torch.cat([y.reshape(e * c, d), y.new_zeros((1, d))])
    per_assign = split_reshape(constrain(y_flat[slot], "tokens", None),
                               (t, k, d), 0, t)
    out = (per_assign * gates.to(y.dtype)[..., None]).float().sum(1)
    out = constrain(out, "tokens", None)
    return out.to(cdt), aux
