"""Closed-loop stream of fixed-size batches through ``ResilientEngine.infer``.

The trigger CLI's stream shape: back-to-back batches of ``batch`` events,
at most ``inflight`` in flight (the oldest realized before the next is
dispatched, as the CLI's double buffer does), cycling through a pool of
``pool_batches`` distinct batches drawn from the seed.  The engine pads
each batch to its bucket.

* ``events_per_s``: valid events of every batch dispatched in the window
  over the seconds from the first dispatch to the last logits on the host.
* ``batch_p99_us``: the 99th percentile over every batch of the window,
  each timed from the call into the engine to its logits on the host.

A sample of ``keep_max`` served batches, drawn from the seed uniformly
over the whole window (a reservoir), keeps its logits; after the window
they are held against the reference on their events.
"""

from __future__ import annotations

import collections
import random
import time

import numpy as np

from bench_port import tracing, trigger


def serve(eng, batches, *, until: float, max_batches: int, inflight: int,
          tracer, keep=None):
    """Dispatch batches round-robin until ``until`` (perf_counter) or
    ``max_batches``; returns (latencies_s, n_dispatched, t_first, t_last).
    Every served batch is offered to ``keep``, whose sample is
    ``keep.kept``."""
    span = tracer.span
    n_pool = len(batches)
    pend = collections.deque()
    lat = []
    i = 0
    t_first = time.perf_counter()
    while True:
        now = time.perf_counter()
        tracer.tick(now)
        if now >= until or i >= max_batches:
            break
        if len(pend) >= inflight:
            _realize(pend, lat, span, keep)
        x = batches[i % n_pool]
        t_call = time.perf_counter()
        with span("engine.dispatch"):
            p = eng.infer(x, sync=False)
        pend.append((t_call, p, i))
        if tracer.active:
            tracer.counts["dispatches"] += 1
            tracer.counts["events"] += x.shape[0]
        i += 1
    while pend:
        _realize(pend, lat, span, keep)
    return lat, i, t_first, time.perf_counter()


def _realize(pend, lat, span, keep) -> None:
    t_call, p, i = pend.popleft()
    with span("engine.realize"):
        out = p.result()
    lat.append(time.perf_counter() - t_call)
    if keep is not None:
        keep.offer(i, out)


class Keep:
    """At most ``cap`` of the batches offered, each as likely as any other
    however many come (reservoir sampling), drawn from ``seed``."""

    def __init__(self, seed: int, cap: int):
        self.rng = random.Random(seed)
        self.cap = cap
        self.kept = []
        self.offered = 0

    def offer(self, i: int, out) -> None:
        if len(self.kept) < self.cap:
            self.kept.append((i, out))
        else:
            j = self.rng.randrange(self.offered + 1)
            if j < self.cap:
                self.kept[j] = (i, out)
        self.offered += 1


def run(run):
    from bench_port.harness import Outcome
    mix = run.cell.mix
    batch, n_pool = int(mix["batch"]), int(mix["pool_batches"])
    inflight = int(mix["inflight"])
    setup = trigger.build(run, max_batch=int(mix["max_batch"]),
                          pool_events=batch * n_pool)
    eng = setup.engine
    batches = [setup.events_host[j * batch:(j + 1) * batch]
               for j in range(n_pool)]
    bucket = eng.bucket_for(batch)
    eng.warm([bucket])
    serve(eng, batches, until=float("inf"),
          max_batches=int(mix["warm_batches"]), inflight=inflight,
          tracer=tracing.Tracer(False))
    run.tracer.warm()
    before = eng.metrics.counters
    keep = Keep(run.seed, int(mix["keep_max"]))
    run.window_opens()
    if run.trace:
        a, b = run.trace_slice()
        run.tracer.arm(run.t_window + a, run.t_window + b)
    lat, n, t_first, t_last = serve(
        eng, batches, until=run.t_window + run.seconds,
        max_batches=1 << 62, inflight=inflight, tracer=run.tracer,
        keep=keep)
    window_s = t_last - t_first
    run.tracer.finish()
    memory = trigger.memory_peak(run.device)
    window = trigger.delta(before, eng.metrics.counters)
    paths = trigger.served_paths(eng)
    failed = trigger.failures(setup, window, n)
    lat_us = np.asarray(lat) * 1e6
    run.log(f"window {window_s:.3f} s: {n} batches of {batch} events "
            f"(bucket {bucket}), buckets served {paths}; batch p50 "
            f"{np.percentile(lat_us, 50):.1f} us, p99 "
            f"{np.percentile(lat_us, 99):.1f} us; kept {len(keep.kept)} "
            f"batches, {sorted(i for i, _ in keep.kept)[:1]} to "
            f"{sorted(i for i, _ in keep.kept)[-1:]}; counters {window}")
    eng = None
    trigger.release(setup)
    served = [((i % n_pool) * batch, (i % n_pool + 1) * batch, out)
              for i, out in keep.kept]
    gap = trigger.judge(run, setup, served)
    limit = float(run.cell.config["logit_gap_limit"])
    return Outcome(
        attempted=n, failed=failed,
        metrics={"events_per_s": n * batch / window_s,
                 "batch_p99_us": float(np.percentile(lat_us, 99))},
        checks={"logit_gap": (gap, limit), "failed": (failed, 0)},
        memory_peak_bytes=memory, counters=window,
        window_events=n * batch)
