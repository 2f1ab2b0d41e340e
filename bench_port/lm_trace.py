"""The LM cell's traced slice: ``tracing``'s reduction, plus the device
time of the kernels the program launched inside each of its own ranges.

The program marks its decode step's latent attention and experts with
the ranges ``lm.mla`` and ``lm.moe`` and a tick's parts with ``lm.admit``
and ``lm.decode`` (``record_function``, live only while a profiler
records).  A kernel belongs to a range when the host call that launched
it (matched by the profiler's correlation id) lies inside one of that
range's host intervals; where the trace carries no such link, when the
kernel lies inside one of the range's device-side intervals.  The
device-side copies of the ranges are annotations, not work: they are
left out of the busy time and the operations (on the card's torch they
lack the ``gpu_user_annotation`` type that ``tracing`` drops).  Idle
gaps are labelled by the innermost harness or program range the host
was in.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

from bench_port import tracing

#: The program's ranges on the LM path, outermost first where they nest.
PROGRAM_RANGES = ("lm.admit", "lm.decode", "lm.mla", "lm.moe")
_MARKS = set(tracing.SPANS) | set(PROGRAM_RANGES) | {tracing.WINDOW_SPAN}


@dataclasses.dataclass
class LMTraceRecord(tracing.TraceRecord):
    #: program range -> [kernels, device seconds] launched inside it
    under: dict = dataclasses.field(default_factory=dict)


class LMTracer(tracing.Tracer):
    """A :class:`tracing.Tracer` whose record is an :class:`LMTraceRecord`."""

    def stop(self) -> None:
        self.active = False
        self._window.__exit__(None, None, None)
        self._sync()
        self._prof.stop()
        self.record = reduce(self._prof, dict(self._host), dict(self.counts))
        self._prof = None


class _Intervals:
    def __init__(self, ivs):
        self.ivs = sorted(ivs)
        self.starts = [s for s, _ in self.ivs]

    def holds(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.ivs[i][1] >= t


def reduce(prof, host_spans: dict, counts: dict) -> LMTraceRecord:
    events = prof.profiler.kineto_results.events()
    window = None
    host = collections.defaultdict(list)      # range -> host intervals
    marks = collections.defaultdict(list)     # range -> device intervals
    launches = {}                             # correlation id -> host time
    device = []
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if name in _MARKS or tracing._activity(ev) in tracing._NOT_WORK:
                marks[name].append((start, end))
                continue
            device.append((start, end, name, ev.correlation_id()))
        elif name == tracing.WINDOW_SPAN:
            window = (start, end)
        elif name in _MARKS:
            host[name].append((start, end))
        elif ev.correlation_id():
            launches[ev.correlation_id()] = start
    if window is None:
        raise RuntimeError("the profiler recorded no bench.window span")
    w0, w1 = window
    ops = collections.defaultdict(lambda: [0, 0.0])
    clipped = []
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e, name, corr))
            ops[name][0] += 1
            ops[name][1] += (e - s) * 1e-9
    busy = tracing._union((s, e) for s, e, _, _ in clipped)
    under = {}
    for rng in PROGRAM_RANGES:
        by_host, by_device = _Intervals(host[rng]), _Intervals(marks[rng])
        n, secs = 0, 0.0
        for s, e, _, corr in clipped:
            t = launches.get(corr)
            inside = (by_host.holds(t) if t is not None
                      else by_device.holds(s) and by_device.holds(e))
            if inside:
                n += 1
                secs += (e - s) * 1e-9
        if n:
            under[rng] = [n, secs]
    labels = tracing._SpanIndex({k: v for k, v in host.items()})
    idle = collections.Counter()
    cursor = w0
    for s, e in busy + [(w1, w1)]:
        if s > cursor:
            idle[labels.at((cursor + s) // 2)] += (s - cursor) * 1e-9
        cursor = max(cursor, e)
    return LMTraceRecord(
        window_s=(w1 - w0) * 1e-9, busy_s=sum(e - s for s, e in busy) * 1e-9,
        device_ops=dict(ops), idle_by_span=dict(idle), host_spans=host_spans,
        counts=counts, under=under)
