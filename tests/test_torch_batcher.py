"""The port's deadline batcher and ``run_plan`` on ``device="cpu"``.

Mirrors the batcher and ``run_plan`` cases of ``tests/test_serving.py``,
holds the port's :class:`DeadlineBatcher` against the reference's on one
scripted submit / poll / flush sequence (the same plans: buckets,
reasons, request maps, waits and deadlines), and checks the served
logits of ``run_plan`` against the JAX ``forward_sr`` on bridged
weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import interaction_net as jinet
from repro.serving import DeadlineBatcher as JaxDeadlineBatcher
from repro_torch import bridge
from repro_torch.core import interaction_net as tinet
from repro_torch.serving import (
    BatchPlan,
    DeadlineBatcher,
    PendingPlan,
    ResilientEngine,
    ResilientPlan,
    ServingEngine,
)

#: fp32 logits of the served path (its plain version here) against the
#: JAX ``forward_sr``: the reference test's bar.
ATOL = 1e-5


@pytest.fixture(scope="module")
def jedi30():
    jcfg = jinet.JediNetConfig(n_objects=30, n_features=16)
    jp = jax.tree_util.tree_map(
        np.asarray, jinet.init(jax.random.PRNGKey(0), jcfg, scale="lecun"))
    cfg = tinet.JediNetConfig(n_objects=30, n_features=16)
    return cfg, bridge.params_from_jax(jp, device="cpu"), jcfg, jp


@pytest.fixture(scope="module")
def engine30(jedi30):
    cfg, params, *_ = jedi30
    return ServingEngine(params, cfg, forward="fused_full", device="cpu",
                         max_batch=32)


def _sr(jedi, x):
    *_, jcfg, jp = jedi
    return np.asarray(jinet.forward_sr(jp, jcfg, jnp.asarray(x)))


# -- parity with the reference batcher -----------------------------------


def _script(bat):
    """One scripted sequence of submits, polls and a flush on a fake
    clock: full cuts, straddling requests, a same-tick deadline and a
    forced drain of a backlog larger than the top bucket."""
    rng = np.random.RandomState(0)
    plans = []
    t = 0.0
    for rid, n in enumerate((3, 5, 11, 1, 7, 2, 19, 4, 6, 40, 2)):
        x = rng.normal(0, 1, (n, 3, 2)).astype(np.float32)
        deadline = None if rid % 3 == 0 else 0.004 * (rid + 1)
        plans += bat.submit(rid, x, now=t, deadline_s=deadline)
        t += 0.0015
        plans += bat.poll(now=t)
    plans += bat.submit(99, np.ones((9, 3, 2), np.float32), now=t)
    plans += bat.flush(now=t + 0.001)
    return plans


def test_batcher_plans_equal_the_reference_batcher():
    ladder = [4, 8, 16]
    got = _script(DeadlineBatcher(ladder, deadline_s=2e-3,
                                  clock=lambda: 0.0))
    want = _script(JaxDeadlineBatcher(ladder, deadline_s=2e-3,
                                      clock=lambda: 0.0))
    assert len(got) == len(want) > 5
    assert {p.reason for p in got} == {"full", "deadline", "forced"}
    for g, w in zip(got, want):
        assert (g.bucket, g.reason, g.requests, g.n_valid) == \
            (w.bucket, w.reason, w.requests, w.n_valid)
        assert g.oldest_wait_s == w.oldest_wait_s
        assert g.deadlines == w.deadlines
        np.testing.assert_array_equal(g.x, w.x)


# -- batcher semantics (tests/test_serving.py) -----------------------------


def test_batcher_flushes_on_full_bucket():
    bat = DeadlineBatcher([8, 16], deadline_s=1.0, clock=lambda: 0.0)
    x = np.zeros((6, 4, 2), np.float32)
    assert bat.submit(0, x, now=0.0) == []
    plans = bat.submit(1, x, now=0.0)
    assert plans == [] and bat.pending_events == 12
    plans = bat.submit(2, x, now=0.0)
    assert len(plans) == 1
    (p,) = plans
    assert p.bucket == 16 and p.n_valid == 16 and p.reason == "full"
    assert [(r[0], r[2] - r[1]) for r in p.requests] == [(0, 6), (1, 6), (2, 4)]
    assert bat.pending_events == 2


def test_batcher_deadline_flush_and_bucket_choice():
    bat = DeadlineBatcher([8, 16], deadline_s=0.010, clock=lambda: 0.0)
    bat.submit(7, np.ones((5, 3), np.float32), now=1.000)
    assert bat.poll(now=1.005) == []
    plans = bat.poll(now=1.011)
    assert len(plans) == 1
    (p,) = plans
    assert p.reason == "deadline"
    assert p.bucket == 8
    assert p.n_valid == 5
    assert p.oldest_wait_s == pytest.approx(0.011)
    assert bat.pending_events == 0
    assert bat.poll(now=2.0) == []


def test_batcher_forced_flush_chunks_backlog():
    bat = DeadlineBatcher([8], deadline_s=10.0, clock=lambda: 0.0)
    bat.submit(0, np.ones((3, 2), np.float32), now=0.0)
    plans = bat.submit(1, np.ones((9, 2), np.float32), now=0.0)
    assert [p.n_valid for p in plans] == [8]
    assert plans[0].reason == "full"
    plans += bat.flush(now=0.0)
    assert [p.n_valid for p in plans] == [8, 4]
    assert plans[1].reason == "forced"
    seg_events = sum(stop - start for p in plans
                     for rid, start, stop in p.requests if rid == 1)
    assert seg_events == 9


def test_batcher_rejects_empty_request():
    bat = DeadlineBatcher([8])
    with pytest.raises(ValueError):
        bat.submit(0, np.zeros((0, 2), np.float32))
    with pytest.raises(ValueError, match="bucket"):
        DeadlineBatcher([])


def test_batcher_full_bucket_and_deadline_same_tick_flush_once():
    bat = DeadlineBatcher([8], deadline_s=0.010, clock=lambda: 0.0)
    bat.submit(0, np.ones((4, 2), np.float32), now=1.000)
    plans = bat.submit(1, np.ones((4, 2), np.float32), now=1.010)
    assert [p.n_valid for p in plans] == [8]
    assert plans[0].reason == "full"
    assert bat.pending_events == 0
    assert bat.poll(now=1.010) == []
    segs = [(rid, stop - start) for p in plans
            for rid, start, stop in p.requests]
    assert segs == [(0, 4), (1, 4)]


def test_batcher_full_cut_tail_keeps_its_own_deadline():
    bat = DeadlineBatcher([8], deadline_s=0.010, clock=lambda: 0.0)
    bat.submit(0, np.ones((4, 2), np.float32), now=1.000)
    plans = bat.submit(1, np.ones((7, 2), np.float32), now=1.010)
    assert [p.n_valid for p in plans] == [8] and bat.pending_events == 3
    assert bat.poll(now=1.010) == []
    plans += bat.poll(now=1.020)
    assert [p.n_valid for p in plans] == [8, 3]
    assert plans[1].reason == "deadline"
    assert bat.poll(now=1.020) == []
    assert sum(stop - start for p in plans
               for rid, start, stop in p.requests if rid == 1) == 7


def test_batcher_zero_deadline_flushes_on_first_poll():
    bat = DeadlineBatcher([8], deadline_s=0.0, clock=lambda: 0.0)
    bat.submit(0, np.ones((2, 2), np.float32), now=5.0)
    (plan,) = bat.poll(now=5.0)
    assert plan.n_valid == 2 and plan.reason == "deadline"
    assert plan.oldest_wait_s == 0.0


def test_batcher_negative_deadline_flushes_immediately():
    bat = DeadlineBatcher([8], deadline_s=-1.0, clock=lambda: 0.0)
    bat.submit(0, np.ones((3, 2), np.float32), now=2.0)
    (plan,) = bat.poll(now=2.0)
    assert plan.n_valid == 3 and plan.reason == "deadline"


def test_batcher_carries_request_deadlines():
    bat = DeadlineBatcher([8], deadline_s=1.0, clock=lambda: 0.0)
    bat.submit(0, np.ones((2, 2), np.float32), now=1.0, deadline_s=0.5)
    bat.submit(1, np.ones((2, 2), np.float32), now=1.0)
    (plan,) = bat.flush(now=1.0)
    assert plan.deadlines == (1.5, None)
    assert plan.deadline_for(0) == 1.5 and plan.deadline_for(1) is None
    legacy = BatchPlan(plan.x, 8, plan.requests, 0.0, "forced")
    assert legacy.deadline_for(0) is None


# -- run_plan on the port's engines ----------------------------------------


def test_batcher_run_plan_reassembles_per_request(jedi30, engine30):
    cfg = jedi30[0]
    bat = DeadlineBatcher(engine30.bucket_sizes, deadline_s=1.0,
                          clock=lambda: 0.0)
    rng = np.random.RandomState(3)
    xs = {rid: rng.normal(0, 1, (n, 30, 16)).astype(np.float32)
          for rid, n in ((10, 3), (11, 5), (12, 2))}
    for rid, x in xs.items():
        bat.submit(rid, x, now=0.0)
    (plan,) = bat.flush(now=0.0)
    results = engine30.run_plan(plan)
    assert set(results) == set(xs)
    for rid, x in xs.items():
        assert results[rid].shape == (x.shape[0], cfg.n_targets)
    got = np.concatenate([results[rid] for rid in xs])
    assert np.abs(got - _sr(jedi30, np.concatenate(list(xs.values())))
                  ).max() < ATOL


def test_run_plan_async_returns_pending_plan(jedi30, engine30):
    bat = DeadlineBatcher(engine30.bucket_sizes, deadline_s=1.0,
                          clock=lambda: 0.0)
    rng = np.random.RandomState(4)
    x = rng.normal(0, 1, (40, 30, 16)).astype(np.float32)  # chunks of 32, 8
    bat.submit(0, x[:25], now=0.0)
    plans = bat.submit(1, x[25:], now=0.0)
    plans += bat.flush(now=0.0)
    handles = [engine30.run_plan(p, sync=False) for p in plans]
    assert all(isinstance(h, PendingPlan) and h.ready for h in handles)
    parts = {0: [], 1: []}
    for h in handles:
        for rid, out in h.result().items():
            parts[rid].append(out)
    got = np.concatenate(parts[0] + parts[1])
    assert np.abs(got - _sr(jedi30, x)).max() < ATOL


def test_pinned_bucket_rides_that_bucket_or_raises(jedi30, engine30):
    x = np.random.RandomState(5).normal(0, 1, (4, 30, 16)).astype(np.float32)
    out = engine30.infer(x, bucket=32)
    assert out.shape == (4, 5)
    assert np.abs(out - _sr(jedi30, x)).max() < ATOL
    with pytest.raises(ValueError, match="not in ladder"):
        engine30.infer(x, bucket=12)
    with pytest.raises(ValueError, match="cannot ride pinned"):
        engine30.infer(np.concatenate([x] * 3), bucket=8)


def test_resilient_run_plan_sheds_expired_segments(jedi30):
    cfg, params, *_ = jedi30
    t = [0.0]
    eng = ResilientEngine(params, cfg, forward="fused_full", device="cpu",
                          max_batch=16, clock=lambda: t[0])
    bat = DeadlineBatcher(eng.bucket_sizes, deadline_s=1.0,
                          clock=lambda: t[0])
    rng = np.random.RandomState(6)
    xa = rng.normal(0, 1, (3, 30, 16)).astype(np.float32)
    xb = rng.normal(0, 1, (4, 30, 16)).astype(np.float32)
    bat.submit(0, xa, now=0.0, deadline_s=0.5)
    bat.submit(1, xb, now=0.0, deadline_s=5.0)
    (plan,) = bat.flush(now=0.0)
    t[0] = 1.0                                   # request 0 has expired
    handle = eng.run_plan(plan, sync=False)
    assert isinstance(handle, ResilientPlan)
    out = handle.result()
    assert out[0] is None
    assert np.abs(out[1] - _sr(jedi30, xb)).max() < ATOL
    assert eng.metrics.counter("shed_requests") == 1
    assert eng.metrics.counter("shed_events") == 3
    t[0] = 10.0                                  # everything expired
    res = eng.run_plan(plan)
    assert res == {0: None, 1: None}
    assert eng.run_plan(plan, sync=False).ready
