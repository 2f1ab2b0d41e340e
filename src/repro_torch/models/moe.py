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

DeepSeek-V3's MoE (:class:`~repro_torch.configs.base.RoutedMoEConfig`,
port only) is :func:`routed_moe_apply`: sigmoid scores, a bias-corrected
choice, shared experts and a DROPLESS grouped product: the assignments
are sorted by expert and each expert's contiguous rows go through
``torch._grouped_mm`` with device offsets, so every assignment is
computed, whatever the routing, and nothing is read back to the host.
A :class:`RouteRecord` can keep the expert ids it chose, on the device.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import resolve_device
from repro_torch.common import prng
from repro_torch.configs.base import MoEConfig, RoutedMoEConfig
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


def routed_moe_shapes(moe: RoutedMoEConfig, d_model: int, d_ff: int) -> dict:
    """``(group, name) -> shape`` of one layer of :func:`routed_moe_apply`'s
    weights: the router (its weight, and the correction bias, kept in
    fp32), the routed experts and the shared experts as one SwiGLU of
    ``n_shared_experts * d_ff``."""
    e, f_sh = moe.n_experts, moe.n_shared_experts * d_ff
    shapes = {
        ("router", "w"): (d_model, e),
        ("router", "bias"): (e,),
        ("experts", "w_gate"): (e, d_model, d_ff),
        ("experts", "w_in"): (e, d_model, d_ff),
        ("experts", "w_out"): (e, d_ff, d_model),
    }
    if f_sh:
        shapes.update({
            ("shared", "w_gate"): (d_model, f_sh),
            ("shared", "w_in"): (d_model, f_sh),
            ("shared", "w_out"): (f_sh, d_model),
        })
    return shapes


#: Spread of the random correction bias: wide enough to move some
#: choices away from the plain top-k of the scores (whose spread is ~0.2
#: at DeepSeek-V3's init), so that a bias applied to the weights would show.
ROUTER_BIAS_STD = 0.1


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


# ---------------------------------------------------------------------------
# DeepSeek-V3's MoE: sigmoid router with a correction bias, shared experts,
# dropless grouped products
# ---------------------------------------------------------------------------

def routed_choice(params, moe: RoutedMoEConfig, x):
    """x: (T, d) -> (weights (T, k) fp32, expert ids (T, k) int64).

    The router's product in fp32 (``x`` and its weight upcast), sigmoid
    scores, the top k of score + correction bias by a stable descending
    sort (ties to the lower expert index), and the chosen scores without
    the bias, normalised (``+ 1e-20``, as ``modeling_deepseek.py``) when
    ``norm_topk_prob``, times ``routed_scaling_factor``."""
    r = params["router"]
    scores = torch.sigmoid(x.float() @ r["w"].float())
    choice = scores + r["bias"].float()
    ids = torch.sort(choice, dim=-1, descending=True,
                     stable=True).indices[:, :moe.top_k]
    w = scores.gather(1, ids)
    if moe.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * moe.routed_scaling_factor, ids


def grouped_mm(x, w, offs):
    """Rows of ``x`` (N, K), sorted by group, times their group's ``w``
    (G, K, M): group g owns rows ``offs[g-1]:offs[g]`` (``offs`` int32
    end offsets on the device; empty groups allowed)."""
    return torch._grouped_mm(x, w, offs=offs)


def _swiglu(x, w_gate, w_in, w_out, act):
    return nn.dot(act(nn.dot(x, w_gate)) * nn.dot(x, w_in), w_out)


def routed_moe_apply(params, moe: RoutedMoEConfig, x, *,
                     compute_dtype=torch.bfloat16, activation: str = "silu",
                     route=None):
    """x: (T, d) -> (T, d) in the compute dtype: y = sum_i w_i E_i(x) +
    S(x), no token dropped.

    Dropless dispatch on the device: the T * k assignments are
    stable-sorted by expert, each expert's end offset found by
    ``searchsorted`` (no ``bincount``, which reads the largest id back),
    the token rows gathered in that order and put through the three
    grouped products, then scattered back to (token, k) order and summed
    with their weights in fp32.  The shared experts' SwiGLU is added in
    fp32 too, and the sum rounded once to the compute dtype.  ``route``,
    a (T, k) integer view of a :class:`RouteRecord`, receives the chosen
    ids (a device copy)."""
    t, d = x.shape
    e, k = moe.n_experts, moe.top_k
    cdt = nn.as_dtype(compute_dtype)
    act = nn.ACTIVATIONS[activation]
    xc = x.to(cdt)
    weights, ids = routed_choice(params, moe, xc)
    if route is not None:
        route.copy_(ids)
    flat = ids.reshape(-1)
    sorted_e, order = torch.sort(flat, stable=True)
    offs = torch.searchsorted(
        sorted_e, torch.arange(e, device=x.device), right=True
    ).to(torch.int32)
    xs = xc.index_select(0, order // k)
    w = params["experts"]
    mid = act(grouped_mm(xs, w["w_gate"].to(cdt), offs)) \
        * grouped_mm(xs, w["w_in"].to(cdt), offs)
    ys = grouped_mm(mid, w["w_out"].to(cdt), offs)
    y = torch.empty_like(ys).index_copy_(0, order, ys).view(t, k, d)
    out = (y.float() * weights[..., None]).sum(1)
    if moe.n_shared_experts:
        sh = params["shared"]
        out = out + _swiglu(xc, sh["w_gate"]["w"].to(cdt),
                            sh["w_in"]["w"].to(cdt),
                            sh["w_out"]["w"].to(cdt), act).float()
    return out.to(cdt)


class RouteRecord:
    """The expert ids an MoE stack chose for every token it was given
    while recording, kept on the device.

    :meth:`take` reserves ``n`` rows of ``(n_layers, top_k)`` uint8 ids
    under a tag, in preallocated chunks of ``chunk_rows`` rows (a new chunk
    when one is full); the model writes each MoE layer's ids into its
    column with a device copy.  Nothing is read back to the host until a
    caller reads :meth:`rows`.  Off unless a caller passes its views:
    :class:`repro_torch.serving.lm.LMEngine` does with ``route_record=``.
    """

    def __init__(self, n_layers: int, top_k: int, *, device,
                 chunk_rows: int = 1 << 18):
        self.n_layers, self.top_k = int(n_layers), int(top_k)
        self.device = resolve_device(device)
        self.chunk_rows = int(chunk_rows)
        self.nbytes = 0
        self._chunk = None
        self._used = 0
        self._views: dict = {}

    def take(self, n: int, tag) -> torch.Tensor:
        """A (n, n_layers, top_k) view for ``tag``'s ``n`` tokens."""
        if self._chunk is None or self._used + n > self._chunk.shape[0]:
            rows = max(n, self.chunk_rows)
            self._chunk = torch.zeros((rows, self.n_layers, self.top_k),
                                      dtype=torch.uint8, device=self.device)
            self.nbytes += self._chunk.numel()
            self._used = 0
        view = self._chunk[self._used:self._used + n]
        self._used += n
        self._views[tag] = view
        return view

    def rows(self, tag) -> torch.Tensor:
        return self._views[tag]
