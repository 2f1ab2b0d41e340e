"""Port parity of the MoE layer: ``repro_torch.models.moe`` against
``repro.models.moe`` on the same numpy inputs and the same weights (made
by the reference's ``init_moe`` and carried across with
``bridge.params_from_jax``), on the CPU.

Bars, on results scaled to max(1, max |value|):

* fp32: 2e-4, the reference's ``PathSpec.tolerance`` for its XLA paths
  (the frameworks sum in other orders: XLA's scatter-add over a token's
  assignments in expert order, the port in k order);
* bf16: 2^-7 of scale, two bf16 ulps: the products round once each in
  both (fp32 sums, one rounding), so a value differs only where an fp32
  sum in another order lands on the other side of a bf16 rounding
  boundary.  A wrong slot, drop or gate moves a token's row by O(1);
* the routing itself (expert ids, kept slots) exactly;
* the init from a ``prng`` key: within 4 ulps of ``jax.random``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoE
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.models import moe as tmoe

TOL_FP32 = 2e-4
TOL_BF16 = 2.0 ** -7
D, FF = 16, 32


def _rel(a, b):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.detach().float().numpy()
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max()))


def _setup(t, e, k, cf, *, seed=0, d=D, ff=FF):
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf)
    jm, tm = JMoE(**kw), TMoE(**kw)
    jp = jax.tree_util.tree_map(
        np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), jm, d, ff))
    x = np.random.RandomState(seed + 1).normal(0, 1, (t, d)).astype(np.float32)
    return jm, tm, jp, bridge.params_from_jax(jp, device="cpu"), x


def _run(jp, tp, jm, tm, x, dtype):
    jo, jaux = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, jp), jm,
                              jnp.asarray(x), compute_dtype=getattr(jnp, dtype))
    to, taux = tmoe.moe_apply(tp, tm, torch.from_numpy(x),
                              compute_dtype=getattr(torch, dtype))
    return jo, jaux, to, taux


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.1])
@pytest.mark.parametrize("t,e,k", [(32, 4, 2), (64, 8, 1), (48, 4, 3)])
def test_moe_apply_matches_the_reference(t, e, k, cf):
    """Output and aux loss in fp32, without drops (8.0) and with drops
    binding (1.25 at these sizes sometimes, 0.1 always)."""
    jm, tm, jp, tp, x = _setup(t, e, k, cf)
    jo, jaux, to, taux = _run(jp, tp, jm, tm, x, "float32")
    assert to.dtype == torch.float32 and to.shape == (t, D)
    assert _rel(jo, to) <= TOL_FP32
    assert abs(float(jaux) - float(taux)) <= TOL_FP32 * max(1.0, float(jaux))
    c = tmoe.capacity(t, tm)
    ids = tmoe.route(tp, tm, torch.from_numpy(x),
                     compute_dtype=torch.float32)[2]
    dropped = int((tmoe.dispatch_slots(ids, tm, c) == e * c).sum())
    if cf == 0.1:
        assert dropped > 0
        # a token all of whose assignments were dropped gets zeros
        assert (np.linalg.norm(np.asarray(jo), axis=-1) < 1e-6).any()
    if cf == 8.0:
        assert dropped == 0


def test_dispatch_slots_follow_the_references_priority():
    """Each kept assignment's buffer row, against the reference's
    arithmetic written as a loop: the first c assignments of each expert
    in (token, k) order take rows e*c .. e*c + c - 1, the rest the
    sentinel."""
    m = TMoE(n_experts=4, top_k=2, capacity_factor=0.5)
    rng = np.random.RandomState(3)
    ids = np.stack([rng.choice(4, 2, replace=False) for _ in range(40)])
    c = tmoe.capacity(40, m)
    fill, want = np.zeros(4, int), []
    for ex in ids.reshape(-1):
        want.append(ex * c + fill[ex] if fill[ex] < c else 4 * c)
        fill[ex] += 1
    got = tmoe.dispatch_slots(torch.from_numpy(ids), m, c)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_router_ties_go_to_the_lower_expert():
    """Router columns duplicated in pairs, so every token's logits tie
    exactly pair by pair: top-3 of 8 takes a whole pair and one expert of
    another, which must be the lower index, as ``jax.lax.top_k`` picks.
    The expert ids equal the reference's exactly; the output is within
    two bf16 ulps of scale."""
    jm, tm, jp, _, x = _setup(64, 8, 3, 1.25)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 1::2] = w[:, 0::2]
    jp["router"]["w"] = w
    tp = bridge.params_from_jax(jp, device="cpu")
    xb = torch.from_numpy(x).to(torch.bfloat16)
    _, _, ids = tmoe.route(tp, tm, xb, compute_dtype=torch.bfloat16)
    logits = (jnp.asarray(x).astype(jnp.bfloat16)
              @ jnp.asarray(w).astype(jnp.bfloat16)).astype(jnp.float32)
    _, jids = jax.lax.top_k(jax.nn.softmax(logits, -1), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    odd = ids.numpy() % 2 == 1                      # an upper twin chosen ...
    has_lower = np.array([[(i - 1) in row for i in row]
                          for row in ids.numpy()])
    assert (~odd | has_lower).all()                 # ... only beside its lower
    jo, jaux, to, taux = _run(jp, tp, jm, tm, x, "bfloat16")
    assert to.dtype == torch.bfloat16
    assert _rel(jo, to) <= TOL_BF16
    assert abs(float(jaux) - float(taux)) <= TOL_FP32 * max(1.0, float(jaux))


@pytest.mark.parametrize("e,k,cf", [(64, 6, 1.25), (128, 2, 1.25),
                                    (4, 2, 0.1), (64, 6, 64 / 6)])
def test_capacity_matches_the_reference(e, k, cf):
    jm, tm = JMoE(n_experts=e, top_k=k, capacity_factor=cf), \
        TMoE(n_experts=e, top_k=k, capacity_factor=cf)
    for t in range(1, 5000, 7):
        assert tmoe.capacity(t, tm) == jmoe.capacity(t, jm)
    assert tmoe.capacity(16, TMoE(n_experts=64, top_k=6)) == 8
    assert tmoe.capacity(1024, TMoE(n_experts=64, top_k=6)) == 120


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_grads_match_jax_grad(cf):
    """Router, expert and input gradients of mean(y^2) + aux against
    ``jax.grad`` in fp32, drops included at 0.5."""
    jm, tm, jp, tp, x = _setup(32, 4, 2, cf)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, jm, xx, compute_dtype=jnp.float32)
        return jnp.mean(jnp.square(y)) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    from repro_torch.common.tree import tree_unflatten
    y, aux = tmoe.moe_apply(tree_unflatten(tp, leaves), tm, tx,
                            compute_dtype=torch.float32)
    (y.square().mean() + aux).backward()
    for a, b in zip(jax.tree_util.tree_leaves(jg), leaves):
        assert _rel(a, b.grad) <= TOL_FP32
    assert _rel(jgx, tx.grad) <= TOL_FP32
    assert float(np.abs(np.asarray(jg["router"]["w"])).max()) > 0


def test_init_moe_from_a_prng_key_replays_the_reference():
    m = TMoE(n_experts=4, top_k=2)
    jp = jmoe.init_moe(jax.random.PRNGKey(3),
                       JMoE(n_experts=4, top_k=2), D, FF)
    tp = tmoe.init_moe(prng.key(3), m, D, FF, device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl) == 4
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32
        ulps = np.abs(a.view(np.int32).astype(np.int64)
                      - b.numpy().view(np.int32).astype(np.int64)).max()
        assert ulps <= 4
    bf = tmoe.init_moe(prng.key(3), m, D, FF, dtype="bfloat16", device="cpu")
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b.to(a.dtype))
               for a, b in zip(tree_leaves(bf), tl))


def test_moe_apply_reads_nothing_back_to_the_host(monkeypatch):
    """The capacity comes from shapes: the layer never turns a tensor
    into a Python value (which on the card would wait for the device)."""
    jm, tm, jp, tp, x = _setup(32, 4, 2, 1.25)

    def refuse(*a, **kw):
        raise AssertionError("host read in moe_apply")
    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out, _ = tmoe.moe_apply(tp, tm, torch.from_numpy(x),
                            compute_dtype=torch.float32)
    monkeypatch.undo()
    assert out.shape == (32, D)
