"""The serving path's spans (``ServingMetrics.span`` / ``interval``) on the
CPU: the engine's ``core.*`` spans per chunk, the live front's
``loop.*`` stages per request, both only while a profiler records."""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import interaction_net as tinet
from repro_torch.serving import ResilientEngine, ServingLoop, ServingMetrics
from repro_torch.serving.core import ExecutionCore, Workload

CORE = ("core.stage", "core.h2d", "core.launch", "core.wait", "core.d2h")
LOOP = ("loop.queued", "loop.blocked", "loop.inflight")


def _profiling():
    return profile(activities=[ProfilerActivity.CPU])


class Doubler(Workload):
    name = "doubler"

    def bucket_ladder(self, max_batch):
        return [4, 8]

    def build(self, bucket):
        return lambda x: x * 2

    def placeholder(self, bucket):
        return np.zeros((bucket, 3), np.float32)


def test_infer_records_each_engine_span_per_chunk():
    """A request of 2.5 top buckets rides three chunks: each span counts
    three, with their nanoseconds, and the answer is unchanged."""
    core = ExecutionCore(Doubler(), max_batch=8)
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    with _profiling():
        out = core.infer(x, sync=False).result()
    np.testing.assert_array_equal(out, 2 * x)
    m = core.metrics
    for name in CORE:
        assert m.counter(name + ".n") == 3
        assert m.counter(name + ".ns") > 0


def test_engine_spans_nest_in_the_callers_range_on_one_clock():
    core = ExecutionCore(Doubler(), max_batch=8)
    x = np.ones((20, 3), np.float32)
    with _profiling() as prof:
        with torch.autograd.profiler.record_function("test.outer"):
            core.infer(x, sync=False).result()
    events = prof.profiler.kineto_results.events()
    by_name = {}
    for ev in events:
        by_name.setdefault(ev.name(), []).append(
            (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    (o0, o1), = by_name["test.outer"]
    for name in CORE:
        assert len(by_name[name]) == 3
        assert all(o0 <= s <= e <= o1 for s, e in by_name[name])
    # one chunk's spans in their order: stage, h2d, launch, then at
    # realization wait and d2h
    firsts = [by_name[name][0] for name in CORE]
    assert all(a[1] <= b[0] for a, b in zip(firsts, firsts[1:]))


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class StubHandle:
    def __init__(self, engine, plan):
        self._engine = engine
        self._plan = plan
        self.ready = False

    def result(self):
        self._engine.clock.t += self._engine.wait_s    # the card's time
        self._engine.outstanding.remove(self)
        return {rid: (None if rid in self._engine.shed
                      else np.full((stop - start, 1), float(rid)))
                for rid, start, stop in self._plan.requests}


class StubEngine:
    """Engine-shaped double whose realization advances the fake clock by
    ``wait_s``; requests in ``shed`` come back shed."""

    def __init__(self, clock, bucket_sizes=(4,), wait_s=0.5):
        self.bucket_sizes = list(bucket_sizes)
        self.metrics = ServingMetrics()
        self.clock = clock
        self.wait_s = wait_s
        self.outstanding = []
        self.shed = set()

    def run_plan(self, plan, *, sync=True):
        h = StubHandle(self, plan)
        self.outstanding.append(h)
        return h


def _scripted_loop():
    """A: 3 events at t=0; B: 3 at t=1 (cut full with A at t=1, split
    across two plans); C: 2 at t=2, cut with B's rest at t=2 and blocked
    at ``max_inflight=1`` until the first plan realizes (t=2.5); D: 4 at
    t=5, shed.  Each realization takes 0.5 s of the clock."""
    clk = FakeClock()
    eng = StubEngine(clk)
    loop = ServingLoop(eng, deadline_s=1e9, max_inflight=1, clock=clk)
    futs = [loop.submit(np.zeros((3, 2), np.float32))]
    clk.t = 1.0
    futs.append(loop.submit(np.zeros((3, 2), np.float32)))
    clk.t = 2.0
    futs.append(loop.submit(np.zeros((2, 2), np.float32)))
    clk.t = 4.0
    loop.drain()
    clk.t = 5.0
    eng.shed.add(3)
    futs.append(loop.submit(np.zeros((4, 2), np.float32)))
    loop.drain()
    assert all(f.done for f in futs) and futs[3].shed
    return eng, futs


def test_loop_stages_are_the_clocks_intervals():
    with _profiling():
        eng, futs = _scripted_loop()
    m = eng.metrics
    # queued: A 1 (0 -> cut 1), B 1 (1 -> cut 2), C 0
    # blocked: A 0, B and C 0.5 (cut 2 -> first plan realized 2.5)
    # in flight: A 1.5 (1 -> 2.5), B and C 2 (2.5 -> 4.5); D shed
    want_s = {"loop.queued": 2.0, "loop.blocked": 1.0, "loop.inflight": 5.5}
    for name, total in want_s.items():
        assert m.counter(name + ".n") == 3
        assert m.counter(name + ".ns") == round(total * 1e9)
    assert [f.result()[0, 0] for f in futs[:3]] == [0.0, 1.0, 2.0]


def test_stages_outside_the_profiler_are_not_recorded():
    """A request submitted before the profiler starts has no stamps; one
    stamped while it records but done after it stops adds nothing."""
    clk = FakeClock()
    eng = StubEngine(clk)
    loop = ServingLoop(eng, deadline_s=1e9, max_inflight=4, clock=clk)
    loop.submit(np.zeros((2, 2), np.float32))
    with _profiling():
        loop.submit(np.zeros((2, 2), np.float32))   # cuts the first plan
        loop.submit(np.zeros((4, 2), np.float32))
    loop.drain()
    assert not loop._stamps
    assert not {k for k in eng.metrics.counters if k.startswith("loop.")}


def _small_engine():
    cfg = tinet.JediNetConfig(n_objects=8, n_features=4)
    params = tinet.init(0, cfg, scale="lecun", device="cpu")
    return cfg, ResilientEngine(params, cfg, forward="sr_split",
                                device="cpu", bucket_sizes=[4, 8])


def _serve(eng, cfg):
    """A stream of async infers and a live loop, as the benchmark drives
    them."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20, cfg.n_objects, cfg.n_features)).astype(
        np.float32)
    out = [eng.infer(x[i:i + 8], sync=False) for i in range(0, 16, 8)]
    [p.result() for p in out]
    loop = ServingLoop(eng, deadline_s=1e9, max_inflight=2)
    futs = [loop.submit(x[i:i + 5]) for i in range(0, 20, 5)]
    loop.drain()
    assert all(f.result() is not None for f in futs)


def test_without_a_profiler_the_counters_are_todays():
    cfg, eng = _small_engine()
    _serve(eng, cfg)
    assert set(eng.health()["counters"]) == {
        "loop_requests", "loop_plans", "loop_completed"}


def test_with_a_profiler_the_counters_add_every_span():
    cfg, eng = _small_engine()
    with _profiling():
        _serve(eng, cfg)
    spans = {k.rsplit(".", 1)[0] for k in eng.health()["counters"]
             if k.endswith(".n")}
    assert spans == set(CORE) | set(LOOP)


def test_without_a_profiler_no_range_is_opened(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function reached with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    cfg, eng = _small_engine()
    _serve(eng, cfg)
    core = ExecutionCore(Doubler(), max_batch=8)
    core.infer(np.ones((4, 3), np.float32))
    with _profiling(), pytest.raises(AssertionError, match="no profiler"):
        core.infer(np.ones((4, 3), np.float32))


def test_metrics_span_and_interval_off_and_on():
    m = ServingMetrics(clock_ns=iter([100, 350]).__next__)
    with m.span("t.a"):
        pass
    m.interval("t.b", 1.0)
    assert m.counters == {}
    with _profiling():
        with m.span("t.a"):
            pass
        m.interval("t.b", 1.5e-6)
    assert m.counter("t.a.n") == 1 and m.counter("t.a.ns") == 250
    assert m.counter("t.b.n") == 1 and m.counter("t.b.ns") == 1500


def test_program_span_names_are_not_the_harness_spans(monkeypatch):
    path = (pathlib.Path(__file__).resolve().parents[1] / "bench_port"
            / "tracing.py")
    spec = importlib.util.spec_from_file_location("bench_port_tracing_",
                                                  path)
    tracing = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, tracing)
    spec.loader.exec_module(tracing)
    harness = set(tracing.SPANS) | {tracing.WINDOW_SPAN}
    assert not harness & (set(CORE) | set(LOOP))
