"""The port's live front-end (``ServingLoop``) on ``device="cpu"``.

Mirrors the trigger cases of ``tests/test_loop.py`` (the LM cases wait
for the LM port) with weights bridged from the JAX reference: loop-served
logits equal direct inference and the JAX ``forward_sr``, deadline
shedding under backlog, bounded in-flight backpressure, out-of-order
delivery and the queue gauges.  One scripted run through a stub engine
holds the port's loop against the reference's: the same deliveries,
counters and gauge peaks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import interaction_net as jinet
from repro.serving import ServingLoop as JaxServingLoop
from repro.serving import ServingMetrics as JaxServingMetrics
from repro_torch import bridge
from repro_torch.core import interaction_net as tinet
from repro_torch.core import paths
from repro_torch.serving import (
    RequestFuture,
    ResilientEngine,
    ServingLoop,
    ServingMetrics,
)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def jedi8():
    jcfg = jinet.JediNetConfig(n_objects=8, n_features=4)
    jp = jax.tree_util.tree_map(np.asarray,
                                jinet.init(jax.random.PRNGKey(0), jcfg))
    cfg = tinet.JediNetConfig(n_objects=8, n_features=4)
    return cfg, bridge.params_from_jax(jp, device="cpu"), jcfg, jp


def _engine(jedi, forward="sr_split", **kw):
    cfg, params = jedi[:2]
    return ResilientEngine(params, cfg, forward=forward, device="cpu", **kw)


# -- numerics: loop-served == direct infer == JAX ---------------------------


@pytest.mark.parametrize("forward", ["sr_split", "fused_full",
                                     "jedi_linear_full"])
def test_loop_matches_direct_infer(jedi8, forward):
    *_, jcfg, jp = jedi8
    eng = _engine(jedi8, forward, bucket_sizes=[4, 8])
    loop = ServingLoop(eng, deadline_s=1e9, max_inflight=2)
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(n, 8, 4)).astype(np.float32)
          for n in (3, 5, 2, 8, 1)]
    futs = [loop.submit(x) for x in xs]
    loop.drain()
    assert loop.idle
    for fut, x in zip(futs, xs):
        assert fut.done and not fut.shed
        out = fut.result()
        assert out.shape[0] == x.shape[0]
        np.testing.assert_allclose(out, eng.infer(x), rtol=1e-5, atol=1e-6)
    if forward != "jedi_linear_full":        # JEDI-linear is its own model
        # each event's logits are its own: one JAX call over all of them
        want = np.asarray(jinet.forward_sr(jp, jcfg,
                                           jnp.asarray(np.concatenate(xs))))
        np.testing.assert_allclose(np.concatenate([f.result() for f in futs]),
                                   want, rtol=0,
                                   atol=paths.get(forward).tolerance)
    assert eng.metrics.counter("loop_requests") == len(xs)
    assert eng.metrics.counter("loop_completed") == len(xs)
    assert eng.metrics.gauge_max("inflight_plans") <= 2


def test_loop_request_split_across_plans_reassembles(jedi8):
    eng = _engine(jedi8, bucket_sizes=[4])
    loop = ServingLoop(eng, deadline_s=1e9)
    x = np.random.default_rng(1).normal(size=(10, 8, 4)).astype(np.float32)
    fut = loop.submit(x)
    loop.drain()
    out = fut.result()
    assert out.shape[0] == 10
    np.testing.assert_allclose(out, eng.infer(x), rtol=1e-5, atol=1e-6)


def test_loop_serves_mixed_sizes_under_the_deadline_fuse(jedi8):
    """Many small requests of mixed size on a fake clock: full cuts and
    deadline flushes, every future completes and equals direct infer."""
    clk = FakeClock()
    eng = _engine(jedi8, "fused_full", max_batch=32, clock=clk)
    loop = ServingLoop(eng, deadline_s=2e-3, max_inflight=4)
    rng = np.random.RandomState(0)
    xs = [rng.normal(0, 1, (int(n), 8, 4)).astype(np.float32)
          for n in rng.randint(1, 41, size=24)]
    futs = []
    for x in xs:
        futs.append(loop.submit(x))
        clk.t += 1e-3
        loop.poll()
    loop.drain()
    for fut, x in zip(futs, xs):
        np.testing.assert_allclose(fut.result(), eng.infer(x), rtol=0,
                                   atol=paths.get("fused_full").tolerance)
    m = eng.metrics
    assert m.counter("loop_completed") == len(xs)
    assert m.gauge_max("inflight_plans") <= 4
    assert m.counter("loop_plans") >= sum(x.shape[0] for x in xs) // 32


# -- deadline shedding under backlog ----------------------------------------


def test_loop_sheds_expired_requests_under_backlog(jedi8):
    clk = FakeClock()
    eng = _engine(jedi8, bucket_sizes=[4, 8], clock=clk)
    loop = ServingLoop(eng, deadline_s=0.5, clock=clk)
    rng = np.random.default_rng(2)
    late = loop.submit(rng.normal(size=(2, 8, 4)).astype(np.float32),
                       deadline_s=1.0)
    clk.t += 10.0
    loop.poll()
    assert late.done and late.shed
    assert late.result() is None
    assert eng.metrics.counter("shed_requests") == 1
    assert eng.metrics.counter("shed_events") == 2
    ok = loop.submit(rng.normal(size=(2, 8, 4)).astype(np.float32),
                     deadline_s=1e9)
    loop.drain()
    assert ok.result() is not None


# -- backpressure + out-of-order delivery (deterministic stub engine) -------


class StubHandle:
    def __init__(self, engine, plan):
        self._engine = engine
        self._plan = plan
        self.ready = False

    def result(self):
        self.ready = True
        self._engine.outstanding.remove(self)
        self._engine.realized.append(self._plan.requests[0][0])
        return {rid: np.full((stop - start, 1), float(rid))
                for rid, start, stop in self._plan.requests}


class StubEngine:
    """Engine-shaped test double: handles complete only when told to."""

    def __init__(self, bucket_sizes=(4,), metrics=None):
        self.bucket_sizes = sorted(bucket_sizes)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.outstanding: list[StubHandle] = []
        self.max_outstanding = 0
        self.realized: list[int] = []     # first request id of each plan

    def run_plan(self, plan, *, sync=True):
        assert not sync
        h = StubHandle(self, plan)
        self.outstanding.append(h)
        self.max_outstanding = max(self.max_outstanding,
                                   len(self.outstanding))
        return h


def test_backpressure_bounds_inflight():
    """Six full buckets against a cap of 2, none ready: every dispatch
    past the cap realizes the OLDEST plan first, and the in-flight gauge
    records the peak the cap allows."""
    eng = StubEngine(bucket_sizes=[4])
    loop = ServingLoop(eng, deadline_s=1e9, max_inflight=2)
    for _ in range(6):
        loop.submit(np.zeros((4, 2), np.float32))
    assert eng.max_outstanding == 2
    assert loop.inflight == 2
    assert eng.realized == [0, 1, 2, 3]
    assert eng.metrics.gauge_max("inflight_plans") == 2
    loop.drain()
    assert loop.idle and not eng.outstanding
    assert eng.realized == [0, 1, 2, 3, 4, 5]
    assert eng.metrics.gauge_value("inflight_plans") == 0


def test_burst_in_one_submit_hits_the_inflight_cap(jedi8):
    """One request of six full buckets, cut and dispatched in one submit
    through a real engine: the loop blocks on the oldest plan at the cap,
    the gauge's peak is the cap, and the reassembled answer equals direct
    inference."""
    eng = _engine(jedi8, "fused_full", bucket_sizes=[4])
    loop = ServingLoop(eng, deadline_s=1e9, max_inflight=2)
    x = np.random.default_rng(5).normal(size=(24, 8, 4)).astype(np.float32)
    realized = []
    realize = loop._realize

    def spy(entry):
        realized.append((entry[0], loop.inflight))
        realize(entry)

    loop._realize = spy
    fut = loop.submit(x)
    assert eng.metrics.counter("loop_plans") == 6
    assert realized[:4] == [(0, 2), (1, 2), (2, 2), (3, 2)]
    assert eng.metrics.gauge_max("inflight_plans") == 2
    loop.drain()
    np.testing.assert_allclose(fut.result(), eng.infer(x), rtol=1e-5,
                               atol=1e-6)


def test_out_of_order_completion_delivers_to_right_futures():
    eng = StubEngine(bucket_sizes=[4])
    loop = ServingLoop(eng, deadline_s=1e9, max_inflight=8)
    futs = [loop.submit(np.zeros((4, 2), np.float32)) for _ in range(3)]
    assert len(eng.outstanding) == 3
    eng.outstanding[2].ready = True
    loop.poll()
    assert futs[2].done and not futs[0].done and not futs[1].done
    np.testing.assert_array_equal(futs[2].result(), np.full((4, 1), 2.0))
    eng.outstanding[0].ready = True
    loop.poll()
    assert futs[0].done and not futs[1].done
    np.testing.assert_array_equal(futs[0].result(), np.full((4, 1), 0.0))
    loop.drain()
    np.testing.assert_array_equal(futs[1].result(), np.full((4, 1), 1.0))


def test_future_result_before_done_raises():
    eng = StubEngine(bucket_sizes=[4])
    loop = ServingLoop(eng, deadline_s=1e9)
    fut = loop.submit(np.zeros((4, 2), np.float32))
    with pytest.raises(RuntimeError, match="in flight"):
        fut.result()
    loop.drain()
    fut.result()


def test_loop_gauges_track_queue_and_inflight():
    eng = StubEngine(bucket_sizes=[8])
    loop = ServingLoop(eng, deadline_s=1e9)
    loop.submit(np.zeros((3, 2), np.float32))
    assert loop.queue_depth == 3
    assert eng.metrics.gauge_value("queue_depth") == 3
    assert eng.metrics.gauge_value("queue_requests") == 1
    loop.submit(np.zeros((5, 2), np.float32))
    assert eng.metrics.gauge_max("queue_depth") == 8
    loop.drain()
    assert eng.metrics.gauge_value("queue_depth") == 0
    assert eng.metrics.gauge_value("inflight_plans") == 0


def test_request_future_partial_shed_is_none():
    fut = RequestFuture(0, 4)
    fut._deliver(0, np.zeros((2, 1)))
    assert not fut.done
    fut._deliver_shed(2)
    assert fut.done and fut.shed
    assert fut.result() is None


# -- parity with the reference loop ------------------------------------------


def _drive(loop_cls, metrics):
    """One scripted run: submits of mixed size on a fake clock, handles
    completed out of order, deadline polls, a drain."""
    clk = FakeClock()
    eng = StubEngine(bucket_sizes=[4, 8], metrics=metrics)
    loop = loop_cls(eng, deadline_s=0.01, max_inflight=3, clock=clk)
    rng = np.random.RandomState(9)
    futs = []
    for i in range(20):
        futs.append(loop.submit(np.zeros((int(rng.randint(1, 7)), 2),
                                         np.float32)))
        clk.t += 0.004
        if eng.outstanding and i % 3 == 0:
            eng.outstanding[-1].ready = True
        loop.poll()
    loop.drain()
    return ([(f.rid, f.done, f.result().tolist()) for f in futs],
            metrics.counters,
            {g: metrics.gauge_max(g) for g in ("queue_depth", "queue_requests")},
            eng.max_outstanding, metrics.gauge_max("inflight_plans"))


def test_loop_behaves_as_the_reference_loop():
    """The same deliveries, counters, queue gauges and engine-side peak
    as the reference loop; the port's ``inflight_plans`` peak is the
    true one (sampled at dispatch), which the reference's, sampled only
    after a reap, never exceeds."""
    *got, got_peak = _drive(ServingLoop, ServingMetrics())
    *want, want_peak = _drive(JaxServingLoop, JaxServingMetrics())
    assert got == want
    assert got[1]["loop_completed"] == 20 and got[3] <= 3
    assert got_peak == got[3] >= want_peak
