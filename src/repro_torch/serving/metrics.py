"""Rolling serving metrics: p50/p99 batch latency + sustained KGPS.

A copy of ``repro.serving.metrics`` (pure numpy): the port imports
nothing of the JAX package.

One accounting surface shared by the engine, the trigger CLI and
``benchmarks/bench_serving.py`` so every consumer reports the same
numbers the same way:

* latencies are *per dispatched batch*, measured host-handoff ->
  logits-ready (what the double-buffered feed loop observes);
* events are the VALID (un-padded) events in the batch — padding rows
  added to reach a compile bucket never inflate throughput;
* KGPS (thousand graphs = events per second) is events / wall over the
  post-warmup stream, not the sum of latencies — with double buffering
  the pipeline sustains more than 1/latency batches per second.
* fault-tolerance events (shed requests, path demotions/re-promotions,
  watchdog timeouts, non-finite batches, ...) land in monotonic named
  COUNTERS (:meth:`ServingMetrics.incr`) — the health state machine
  (:mod:`repro.serving.resilient`) and ``trigger_serve --health`` read
  them off the same snapshot as the latency percentiles.
* instantaneous levels (queue depth, in-flight dispatches, free decode
  slots, ...) land in GAUGES (:meth:`ServingMetrics.gauge`) — set, not
  summed — so the event loop and the LM slot scheduler surface their
  current occupancy in the same ``snapshot()`` / ``--health`` report as
  the monotonic counters; each gauge also remembers its high-water mark
  (``<name>_max``), which is what backlog tests and capacity planning
  actually read.
* counter and gauge mutation is LOCKED: the sentinel's shadow worker
  (:mod:`repro_torch.serving.sentinel`) increments from its own thread while
  the serve thread records batches — ``Counter.__iadd__`` is a
  read-modify-write, and a lost ``shadow_disagreements`` increment is a
  lost corruption signal.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np


def percentile(xs, q: float) -> float:
    """float percentile of a sequence (empty -> nan)."""
    if len(xs) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(xs), q))


def kgps(events: int, wall_s: float) -> float:
    """Sustained thousand-events-per-second (nan when wall is degenerate)."""
    return events / wall_s / 1e3 if wall_s > 0 else float("nan")


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    latency_s: float
    events: int          # valid events (padding excluded)
    bucket: int          # compile-bucket batch size the events rode in


class ServingMetrics:
    """Rolling window of per-batch records with percentile / KGPS views."""

    def __init__(self, window: int = 4096):
        self._records: collections.deque[BatchRecord] = collections.deque(
            maxlen=window)
        self._wall_s = 0.0       # accumulated post-warmup stream wall time
        self._wall_events = 0    # valid events covered by _wall_s
        self._counters: collections.Counter[str] = collections.Counter()
        self._gauges: dict[str, float] = {}
        self._gauge_peaks: dict[str, float] = {}
        self._lock = threading.Lock()

    def record_batch(self, latency_s: float, events: int, bucket: int) -> None:
        self._records.append(BatchRecord(latency_s, events, bucket))

    def incr(self, name: str, n: int = 1) -> None:
        """Bump a monotonic named counter (shed / demotion / timeout /
        ... — the fault-tolerance layer's accounting surface).
        Thread-safe: shadow-verification threads increment concurrently
        with the serve thread."""
        with self._lock:
            self._counters[name] += n

    def counter(self, name: str) -> int:
        return self._counters[name]

    @property
    def counters(self) -> dict:
        """Copy of all non-zero counters (stable for snapshotting)."""
        return {k: v for k, v in sorted(self._counters.items()) if v}

    def gauge(self, name: str, value: float) -> None:
        """Set an instantaneous level (queue depth, inflight count, free
        slots, ...).  Unlike :meth:`incr` the value REPLACES the previous
        one; the high-water mark is tracked alongside as ``<name>_max``."""
        value = float(value)
        with self._lock:
            self._gauges[name] = value
            peak = self._gauge_peaks.get(name)
            if peak is None or value > peak:
                self._gauge_peaks[name] = value

    def gauge_value(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

    def gauge_max(self, name: str, default: float = 0.0) -> float:
        """High-water mark of ``name`` since this metrics object was
        created (backlog tests / capacity planning read this)."""
        return self._gauge_peaks.get(name, default)

    @property
    def gauges(self) -> dict:
        """Copy of the current gauge levels (stable for snapshotting)."""
        return dict(sorted(self._gauges.items()))

    def record_wall(self, wall_s: float, events: int) -> None:
        """Fold a measured stream segment into the sustained-KGPS estimate."""
        self._wall_s += wall_s
        self._wall_events += events

    @property
    def batches(self) -> int:
        return len(self._records)

    @property
    def events(self) -> int:
        return sum(r.events for r in self._records)

    def latencies_s(self) -> list[float]:
        return [r.latency_s for r in self._records]

    def snapshot(self) -> dict:
        """One dict with everything the CLI / benchmark prints."""
        lats = self.latencies_s()
        evs = [r.events for r in self._records]
        mean_events = float(np.mean(evs)) if evs else float("nan")
        p50_us = percentile(lats, 50) * 1e6
        p99_us = percentile(lats, 99) * 1e6
        return {
            "batches": self.batches,
            "events": self.events,
            "p50_us": p50_us,
            "p99_us": p99_us,
            "per_event_p50_us": p50_us / mean_events if evs else float("nan"),
            "per_event_p99_us": p99_us / mean_events if evs else float("nan"),
            "kgps": kgps(self._wall_events, self._wall_s),
            "buckets": sorted({r.bucket for r in self._records}),
            "counters": self.counters,
            "gauges": self.gauges,
        }
