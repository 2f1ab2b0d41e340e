"""The traced run: a short steady slice of the window under ``torch.profiler``.

A ``--trace 1`` run profiles a slice of its window (CPU and CUDA
activities).  The harness marks its calls into each layer of the program
with ``record_function`` spans (:data:`SPANS`) from its own files, and
times the same spans on the host clock.  :func:`reduce` turns the
profiler's events into a :class:`TraceRecord`: the slice's length, the
union of the card's kernel / copy / set intervals (busy time), the device
time by operation name, and the card's idle gaps labelled by the
innermost harness span the host was in.  The per-layer metric readers
(``bench_port/metrics/*.py``) read the record.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time

import torch

#: The harness's spans, outermost first where they nest.
SPANS = ("arrival.wait", "front.submit", "front.poll", "engine.dispatch",
         "engine.realize")
WINDOW_SPAN = "bench.window"

#: Activity types of device events that are not work on the card.
_NOT_WORK = {"gpu_user_annotation"}


@dataclasses.dataclass
class TraceRecord:
    window_s: float                     # the traced slice
    busy_s: float                       # union of device work in the slice
    device_ops: dict                    # name -> [launches, seconds]
    idle_by_span: dict                  # harness span -> idle seconds
    host_spans: dict                    # span -> [seconds, ...] (host clock)
    counts: dict                        # what the runner counted in the slice


class Tracer:
    """Profiles one slice of the window when enabled; spans are no-ops
    outside the slice (and in a ``--trace 0`` run)."""

    def __init__(self, enabled: bool, device=None):
        self.enabled = bool(enabled)
        self.device = torch.device("cuda") if device is None else device
        self.active = False
        self.record: TraceRecord | None = None
        self.counts: collections.Counter = collections.Counter()
        self._host = collections.defaultdict(list)
        self._prof = None
        self._window = None
        self._slice = None

    def arm(self, t_start: float, t_stop: float) -> None:
        """Trace from ``t_start`` to ``t_stop`` (perf_counter) as
        :meth:`tick` reaches them."""
        self._slice = (t_start, t_stop)

    def tick(self, now: float) -> None:
        if self._slice is None:
            return
        if not self.active and self.record is None and now >= self._slice[0]:
            self.start()
        elif self.active and now >= self._slice[1]:
            self.stop()

    def finish(self) -> None:
        """End a slice the window outran."""
        if self.active:
            self.stop()

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that its own
        start-up (CUPTI) does not fall inside the window."""
        if not self.enabled:
            return
        prof = _profiler(self.device)
        prof.start()
        torch.ones(8, device=self.device).add_(1)
        self._sync()
        prof.stop()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._prof = _profiler(self.device)
        self._prof.start()
        self._window = torch.autograd.profiler.record_function(WINDOW_SPAN)
        self._window.__enter__()
        self.active = True

    def stop(self) -> None:
        self.active = False
        self._window.__exit__(None, None, None)
        self._sync()
        self._prof.stop()
        self.record = reduce(self._prof, dict(self._host), dict(self.counts))
        self._prof = None

    def span(self, name: str):
        if not self.active:
            return _NULL_SPAN
        return _Span(self._host[name], name)


_NULL_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("_durations", "_name", "_rf", "_t0")

    def __init__(self, durations: list, name: str):
        self._durations = durations
        self._name = name

    def __enter__(self):
        self._rf = torch.autograd.profiler.record_function(self._name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._durations.append(time.perf_counter() - self._t0)
        self._rf.__exit__(*exc)
        return False


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _activity(ev) -> str:
    fn = getattr(ev, "activity_type", None)
    return str(fn()) if fn is not None else ""


def _union(intervals) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce(prof, host_spans: dict, counts: dict) -> TraceRecord:
    """The :class:`TraceRecord` of a stopped profiler (see module doc)."""
    events = prof.profiler.kineto_results.events()
    window = None
    spans = collections.defaultdict(list)
    device = []
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if name in SPANS or name == WINDOW_SPAN \
                    or _activity(ev) in _NOT_WORK:
                continue
            device.append((start, end, name))
        elif name == WINDOW_SPAN:
            window = (start, end)
        elif name in SPANS:
            spans[name].append((start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no bench.window span")
    w0, w1 = window
    ops = collections.defaultdict(lambda: [0, 0.0])
    clipped = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        ops[name][0] += 1
        ops[name][1] += (e - s) * 1e-9
    busy = _union(clipped)
    busy_ns = sum(e - s for s, e in busy)
    labels = _SpanIndex(spans)
    idle = collections.Counter()
    cursor = w0
    for s, e in busy + [(w1, w1)]:
        if s > cursor:
            idle[labels.at((cursor + s) // 2)] += (s - cursor) * 1e-9
        cursor = max(cursor, e)
    return TraceRecord(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                       device_ops=dict(ops), idle_by_span=dict(idle),
                       host_spans=host_spans, counts=counts)


class _SpanIndex:
    """The innermost harness span covering a time: of the spans that cover
    it, the one that started last.  Spans of one name never overlap."""

    def __init__(self, spans: dict):
        self._by_name = {}
        for name, ivs in spans.items():
            ivs = sorted(ivs)
            self._by_name[name] = ([s for s, _ in ivs], ivs)

    def at(self, t: int) -> str:
        best, best_start = "other", None
        for name, (starts, ivs) in self._by_name.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ivs[i][1] >= t:
                if best_start is None or ivs[i][0] > best_start:
                    best, best_start = name, ivs[i][0]
        return best


def breakdown(rec: TraceRecord, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time, and the card's idle time by the harness span the host was
    in, each as [[name, seconds], ...]."""
    ops = sorted(rec.device_ops.items(), key=lambda kv: -kv[1][1])[:top]
    idle = sorted(rec.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:120], secs] for name, (_, secs) in ops],
            "idle_gaps": [[name, secs] for name, secs in idle]}
