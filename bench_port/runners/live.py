"""Open-loop arrivals through the live front, ``ServingLoop`` over
``ResilientEngine``.

Requests of ``size_min``-``size_max`` events arrive as a Poisson stream
at ``rate_per_s``.  Each is submitted at its due time; between arrivals
the harness calls ``poll()``.  The loop cuts plans with its
``DeadlineBatcher`` (full bucket, or the ``deadline_s`` fuse), at most
``max_inflight`` in flight, over an engine whose top bucket is
``max_batch``.  No request carries a deadline, so nothing is shed.

Every seed gets the same work: the request sizes and the gaps between
arrivals are one multiset drawn from the mix's ``shape_seed`` (the gaps
are those of ``rate_per_s * seconds`` arrivals uniform over the window,
a Poisson stream conditioned on its count); the run's seed shuffles both
and picks each request's events from the pool it draws.

* ``request_p50_us`` / ``request_p99_us``: over every request of the
  window, each timed from its due time to the first moment the harness
  sees its future done, so a stall delays every request behind it.

After the window every request's logits are held against the reference.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import numpy as np

from bench_port import trigger
from bench_port.harness import steady_heap


@dataclasses.dataclass
class Schedule:
    due: np.ndarray          # seconds into the window
    sizes: np.ndarray        # events per request
    offsets: np.ndarray      # first event of each request in the pool


def schedule(mix: dict, rate: float, seconds: float, seed: int,
             pool_events: int) -> Schedule:
    n = max(1, int(round(rate * seconds)))
    base = np.random.default_rng(int(mix["shape_seed"]))
    sizes = base.integers(int(mix["size_min"]), int(mix["size_max"]) + 1, n)
    arrivals = np.sort(base.uniform(0.0, seconds, n))
    gaps = np.diff(arrivals, prepend=0.0)
    own = np.random.default_rng(int(seed))
    gaps = own.permutation(gaps)
    sizes = own.permutation(sizes)
    offsets = own.integers(0, pool_events - sizes + 1)
    return Schedule(due=np.cumsum(gaps), sizes=sizes, offsets=offsets)


class _SpannedEngine:
    """The engine with the harness's spans around the front's calls into
    it (traced runs only)."""

    def __init__(self, engine, tracer):
        self._engine = engine
        self._tracer = tracer

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def run_plan(self, plan, *, sync: bool = True):
        with self._tracer.span("engine.dispatch"):
            handle = self._engine.run_plan(plan, sync=sync)
        return handle if sync else _SpannedHandle(handle, self._tracer)


class _SpannedHandle:
    def __init__(self, handle, tracer):
        self._handle = handle
        self._tracer = tracer

    @property
    def ready(self) -> bool:
        return self._handle.ready

    def result(self):
        with self._tracer.span("engine.realize"):
            return self._handle.result()


@dataclasses.dataclass
class Served:
    futures: list
    done_at: np.ndarray      # seconds into the window; nan: never done
    late_s: np.ndarray       # submission time minus due time
    backlog: list            # (seconds, requests due and not yet done)


def drive(loop, pool: np.ndarray, sched: Schedule, *, t0: float,
          drain_s: float, tracer) -> Served:
    """Submit every request at its due time (``t0`` + due, perf_counter)
    and poll between arrivals until every future is done, or ``drain_s``
    past the last due time."""
    span = tracer.span
    n = len(sched.due)
    futures = [None] * n
    done_at = np.full(n, np.nan)
    late = np.zeros(n)
    backlog = []
    pending = []
    due = sched.due.tolist()
    sizes = sched.sizes.tolist()
    offsets = sched.offsets.tolist()
    give_up = due[-1] + drain_s
    next_sample = 0.0
    n_done = 0
    k = 0
    while True:
        now = time.perf_counter() - t0
        tracer.tick(now + t0)
        if k < n and due[k] <= now:
            off = offsets[k]
            with span("front.submit"):
                futures[k] = loop.submit(pool[off:off + sizes[k]])
            late[k] = now - due[k]
            pending.append(k)
            if tracer.active:
                tracer.counts["requests"] += 1
                tracer.counts["events"] += sizes[k]
            k += 1
        elif pending:
            with span("front.poll"):
                loop.poll()
        elif k < n:
            with span("arrival.wait"):
                target = t0 + due[k]
                while time.perf_counter() < target:
                    pass
            continue
        else:
            break
        if pending:
            t = time.perf_counter() - t0
            still = []
            for j in pending:
                if futures[j].done:
                    done_at[j] = t
                    n_done += 1
                else:
                    still.append(j)
            pending = still
        if now >= next_sample:
            backlog.append((now, bisect.bisect_right(due, now) - n_done))
            next_sample = now + 1e-3
        if now > give_up:
            break
    return Served(futures=futures, done_at=done_at, late_s=late,
                  backlog=backlog)


def make_loop(engine, mix: dict):
    from repro_torch.serving.loop import ServingLoop
    return ServingLoop(engine, deadline_s=float(mix["deadline_s"]),
                       max_inflight=int(mix["max_inflight"]))


def prepare(run):
    """Set-up: weights, pool, engine, every rung of its ladder warmed, and
    a short burst through a loop of its own."""
    mix = run.cell.mix
    setup = trigger.build(run, max_batch=int(mix["max_batch"]),
                          pool_events=int(mix["pool_events"]))
    setup.engine.warm()
    warm = make_loop(setup.engine, mix)
    rng = np.random.default_rng(0)
    pool = setup.events_host
    for _ in range(int(mix["warm_requests"])):
        size = int(rng.integers(int(mix["size_min"]), int(mix["size_max"]) + 1))
        off = int(rng.integers(0, pool.shape[0] - size + 1))
        warm.submit(pool[off:off + size])
        warm.poll()
    warm.drain()
    return setup


def window(run, setup, rate: float, seconds: float, *, trace: bool):
    """One window at ``rate``: the requests' latencies and what the check
    and the knee need."""
    mix = run.cell.mix
    sched = schedule(mix, rate, seconds, run.seed, setup.events_host.shape[0])
    engine = setup.engine
    if trace:
        engine = _SpannedEngine(engine, run.tracer)
    loop = make_loop(engine, mix)
    before = setup.engine.metrics.counters
    if run.t_window is None:
        run.window_opens()
        t0 = run.t_window
    else:
        steady_heap()
        t0 = time.perf_counter()
    if trace:
        a, b = run.trace_slice()
        run.tracer.arm(t0 + a, t0 + b)
    served = drive(loop, setup.events_host, sched, t0=t0,
                   drain_s=float(mix["drain_s"]), tracer=run.tracer)
    run.tracer.finish()
    counters = trigger.delta(before, setup.engine.metrics.counters)
    return sched, served, counters


def knee_reading(sched: Schedule, served: Served, seconds: float) -> dict:
    """Offered and completed requests/s over the window, and the mean
    backlog (requests due and not yet done, the batcher's queue and what
    waits behind a blocked submit alike) in its first and second half."""
    done_in = np.sum(served.done_at <= seconds)
    first = [q for t, q in served.backlog if t < seconds / 2]
    second = [q for t, q in served.backlog if seconds / 2 <= t <= seconds]
    return {"offered_per_s": len(sched.due) / seconds,
            "completed_per_s": float(done_in) / seconds,
            "backlog_first": float(np.mean(first)) if first else 0.0,
            "backlog_second": float(np.mean(second)) if second else 0.0}


def run(run):
    from bench_port.harness import Outcome
    mix = run.cell.mix
    setup = prepare(run)
    run.tracer.warm()
    sched, served, counters = window(run, setup, float(mix["rate_per_s"]),
                                     run.seconds, trace=run.trace)
    memory = trigger.memory_peak(run.device)
    paths = trigger.served_paths(setup.engine)
    lat_us = (served.done_at - sched.due) * 1e6
    unfinished = int(np.isnan(lat_us).sum())
    done = lat_us[~np.isnan(lat_us)]
    failed = min(len(sched.due),
                 trigger.failures(setup, counters, len(sched.due))
                 + unfinished)
    events = int(sched.sizes.sum())
    k = knee_reading(sched, served, run.seconds)
    run.log(f"window {run.seconds:.3f} s: {len(sched.due)} requests, "
            f"{events} events, {counters.get('loop_plans', 0)} plans; "
            f"buckets served {paths}; request p50 "
            f"{np.percentile(done, 50) if done.size else float('nan'):.1f} "
            f"us, p99 "
            f"{np.percentile(done, 99) if done.size else float('nan'):.1f} "
            f"us; submission late p99 "
            f"{np.percentile(served.late_s, 99) * 1e6:.1f} us; {k}; "
            f"counters {counters}")
    answers = []
    for j, fut in enumerate(served.futures):
        off, size = int(sched.offsets[j]), int(sched.sizes[j])
        out = fut.result() if fut is not None and fut.done else None
        answers.append((off, off + size, out))
    trigger.release(setup)
    gap = trigger.judge(run, setup, answers)
    limit = float(run.cell.config["logit_gap_limit"])
    p50 = float(np.percentile(done, 50)) if done.size else float("inf")
    p99 = float(np.percentile(done, 99)) if done.size else float("inf")
    return Outcome(
        attempted=len(sched.due), failed=failed,
        metrics={"request_p50_us": p50, "request_p99_us": p99},
        checks={"logit_gap": (gap, limit), "failed": (failed, 0)},
        memory_peak_bytes=memory, counters=counters, window_events=events)
