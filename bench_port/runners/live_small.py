"""Open-loop arrivals of small requests through the live front: requests
of 1 + Poisson(``size_mean`` - 1) events, so a plan packs many requests
and the ``deadline_s`` fuse cuts it.

The size mix is the JAX harness's live mix
(``benchmarks/bench_serving.py``: ``1 + rng.poisson(3)`` events a
request), cited and not run.  Everything else is ``runners/live.py``'s:
``ServingLoop`` over ``ResilientEngine``, Poisson arrivals at
``rate_per_s``, one multiset of sizes and gaps from ``shape_seed``
shuffled by the run's seed, ``request_p50_us`` from each request's due
time, every request's logits held against the reference.  This module
replaces only the schedule's size draw.
"""

from __future__ import annotations

import time

import numpy as np

from bench_port import trigger
from bench_port.harness import steady_heap
from bench_port.runners import live


def schedule(mix: dict, rate: float, seconds: float, seed: int,
             pool_events: int) -> live.Schedule:
    n = max(1, int(round(rate * seconds)))
    base = np.random.default_rng(int(mix["shape_seed"]))
    sizes = 1 + base.poisson(float(mix["size_mean"]) - 1.0, n)
    arrivals = np.sort(base.uniform(0.0, seconds, n))
    gaps = np.diff(arrivals, prepend=0.0)
    own = np.random.default_rng(int(seed))
    gaps = own.permutation(gaps)
    sizes = own.permutation(sizes)
    offsets = own.integers(0, pool_events - sizes + 1)
    return live.Schedule(due=np.cumsum(gaps), sizes=sizes, offsets=offsets)


def prepare(run):
    """``live.prepare``'s set-up, its warm burst drawn from this mix."""
    mix = run.cell.mix
    setup = trigger.build(run, max_batch=int(mix["max_batch"]),
                          pool_events=int(mix["pool_events"]))
    setup.engine.warm()
    warm = live.make_loop(setup.engine, mix)
    pool = setup.events_host
    sched = schedule(mix, float(mix["warm_requests"]), 1.0, 0, pool.shape[0])
    for off, size in zip(sched.offsets.tolist(), sched.sizes.tolist()):
        warm.submit(pool[off:off + size])
        warm.poll()
    warm.drain()
    return setup


def window(run, setup, rate: float, seconds: float, *, trace: bool):
    """``live.window`` with this mix's schedule."""
    mix = run.cell.mix
    sched = schedule(mix, rate, seconds, run.seed, setup.events_host.shape[0])
    engine = setup.engine
    if trace:
        engine = live._SpannedEngine(engine, run.tracer)
    loop = live.make_loop(engine, mix)
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
    served = live.drive(loop, setup.events_host, sched, t0=t0,
                        drain_s=float(mix["drain_s"]), tracer=run.tracer)
    run.tracer.finish()
    counters = trigger.delta(before, setup.engine.metrics.counters)
    return sched, served, counters


def run(run):
    from bench_port.harness import Outcome
    mix = run.cell.mix
    setup = prepare(run)
    run.tracer.warm()
    sched, served, counters = window(run, setup, float(mix["rate_per_s"]),
                                     run.seconds, trace=run.trace)
    memory = trigger.memory_peak(run.device)
    lat_us = (served.done_at - sched.due) * 1e6
    unfinished = int(np.isnan(lat_us).sum())
    done = lat_us[~np.isnan(lat_us)]
    failed = min(len(sched.due),
                 trigger.failures(setup, counters, len(sched.due))
                 + unfinished)
    events = int(sched.sizes.sum())
    run.log(f"window {run.seconds:.3f} s: {len(sched.due)} requests, "
            f"{events} events, {counters.get('loop_plans', 0)} plans; "
            f"buckets served {trigger.served_paths(setup.engine)}; request "
            f"p50 {np.percentile(done, 50) if done.size else float('nan'):.1f}"
            f" us; {live.knee_reading(sched, served, run.seconds)}; counters "
            f"{counters}")
    answers = []
    for j, fut in enumerate(served.futures):
        off, size = int(sched.offsets[j]), int(sched.sizes[j])
        out = fut.result() if fut is not None and fut.done else None
        answers.append((off, off + size, out))
    trigger.release(setup)
    gap = trigger.judge(run, setup, answers)
    limit = float(run.cell.config["logit_gap_limit"])
    p50 = float(np.percentile(done, 50)) if done.size else float("inf")
    return Outcome(
        attempted=len(sched.due), failed=failed,
        metrics={"request_p50_us": p50},
        checks={"logit_gap": (gap, limit), "failed": (failed, 0)},
        memory_peak_bytes=memory, counters=counters, window_events=events)
