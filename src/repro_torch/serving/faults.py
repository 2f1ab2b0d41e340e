"""Deterministic fault injection at the serving engine's seams.

A copy of ``repro.serving.faults`` for the port.  Two changes: weights
may be torch tensors (``corrupt_weight`` tells integer from float
tensors either way), and :class:`StuckBuffer` duck-types the port's
readiness surface — ``is_ready()`` where a CUDA result answers from
``torch.cuda.Event.query()``, ``synchronize()`` where it waits on the
event, and ``__array__`` for the copy to the host.

A Level-1 trigger pipeline is judged by how it behaves when things go
wrong: the real-time trigger literature (arXiv 2307.07289) treats
continuous degraded operation as a first-class requirement, and you
cannot claim "the engine demotes on a compile failure" without a way to
*cause* a compile failure on demand, on CPU, in a unit test.  This
module is that way.

A :class:`FaultInjector` is handed to :class:`~repro.serving.engine.
ServingEngine` (and through it to :class:`~repro.serving.resilient.
ResilientEngine`).  The engine calls the injector at well-defined seams
of its dispatch path; an armed :class:`Fault` matching that seam fires
there.  Everything is deterministic — faults are armed with explicit
``times`` budgets and matched by (seam, path, bucket), never by random
draw — so every degraded-mode transition (demote, probe, re-promote,
shed, watchdog timeout) is reproducible in CI.

Seams
-----
``compile``
    Fires inside ``ServingEngine.compiled_for`` on a cache MISS (a warm
    cache never recompiles, so neither can it re-fail).  Models a
    kernel build failure on a new bucket shape.
``dispatch``
    Fires in ``ServingEngine.infer`` just before the chunk is handed to
    the compiled callable.  Models a runtime dispatch exception
    (device OOM, donated-buffer reuse, ...).
``input_nan``
    Overwrites the chunk's first event with NaNs before dispatch.
    Models path-local data corruption (a bad quantization scale, a DMA
    bit-flip) — scoped to one path, so the fallback rung still serves
    clean outputs.
``output_nan``
    Replaces the dispatched output with NaNs.  Models a kernel
    numerics bug: outputs come back shaped but non-finite.
``latency``
    Sleeps ``delay_s`` at dispatch.  Models a slow rung (preempted
    core, thermally throttled part) for deadline/backpressure drills.
``stuck``
    Wraps the output in a :class:`StuckBuffer` that only becomes ready
    after ``delay_s``.  Models a hung dispatch — the seam the engine's
    watchdog (``PendingResult.result(timeout_s=...)``) exists for.

Silent seams
------------
The seams above all trip a loud detector: an exception, a NaN, or a
watchdog timeout.  The three **silent** seams below produce *finite,
shaped, wrong* answers — the failure mode a Level-1 trigger fears most,
because ``health()`` keeps reading ``healthy`` while physics is being
misclassified.  They exist to prove that gap (no loud detector fires);
the reference's sentinel closes it, and the port's sentinel is still
to come.
All three fire at the compile-cache BUILD seam: corruption lands in the
cached callable, persists across dispatches (like a corrupted weight in
HBM or a poisoned cache entry), and is only cleared by rebuilding the
entry.

``scale_drift``
    Multiplies every int8 quantization scale (``"w_scale"`` leaf) by
    ``factor`` before the bucket's callable is built.  Models a drifted
    or corrupted dequantization scale: logits come back finite and
    plausibly shaped, just wrong.  A no-op on paths without quantized
    params (nothing to drift — the fault does not fire).
``weight_corrupt``
    Corrupts the first weight tensor (``"w"`` leaf): sign-flipped for
    integer (quantized) tensors, scaled by ``factor`` for floats.
    Models an SEU/HBM bit-flip class corruption of a cached param.
``stale_cache``
    Wraps the freshly built callable in :class:`StaleCacheFn`, which
    returns the PREVIOUS dispatch's output for every call after the
    first.  Models a stale/aliased compile-cache entry: answers are
    real logits — for somebody else's events.

Every firing is appended to :attr:`FaultInjector.log` as
``(seam, path, bucket)`` so tests can assert exactly which seams fired.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

#: Seams whose firing trips a loud detector (exception / NaN / timeout).
LOUD_SEAMS = ("compile", "dispatch", "input_nan", "output_nan", "latency",
              "stuck")

#: Seams that produce finite wrong answers no loud detector sees — the
#: sentinel's coverage target.  All fire at the compile-cache build.
SILENT_SEAMS = ("scale_drift", "weight_corrupt", "stale_cache")

SEAMS = LOUD_SEAMS + SILENT_SEAMS


class InjectedFault(RuntimeError):
    """Raised by the ``compile`` / ``dispatch`` seams when a fault fires.

    Carries the seam so the resilience layer can classify the failure
    (and tests can assert the transition it caused) without string
    matching."""

    def __init__(self, seam: str, path=None, bucket=None):
        self.seam = seam
        self.path = path
        self.bucket = bucket
        super().__init__(
            f"injected {seam} fault (path={path!r}, bucket={bucket})")


@dataclasses.dataclass
class Fault:
    """One armed fault: where it fires, how often, how hard.

    ``path`` / ``bucket`` of ``None`` match any path / bucket.  ``times``
    is the firing budget — after that many firings the fault disarms
    itself, which is how tests script "fail once, then recover".
    """

    seam: str
    path: str | None = None
    bucket: int | None = None
    times: float = math.inf
    delay_s: float = 0.0
    factor: float = 2.0          # corruption magnitude (silent seams)
    fired: int = 0

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown seam {self.seam!r}; one of {SEAMS}")

    @property
    def armed(self) -> bool:
        return self.fired < self.times

    def matches(self, seam: str, path, bucket) -> bool:
        return (self.armed and self.seam == seam
                and (self.path is None or self.path == path)
                and (self.bucket is None or self.bucket == bucket))


def drift_scales(params, factor: float):
    """``scale_drift``: every ``"w_scale"`` leaf multiplied by ``factor``.

    Returns the corrupted pytree copy, or ``params`` UNCHANGED (same
    object) when there is nothing to drift — the caller uses identity to
    decide whether the fault actually applies to this workload.
    """
    hits = [0]

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "w_scale":
                    out[k] = v * factor
                    hits[0] += 1
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    corrupted = walk(params)
    return corrupted if hits[0] else params


def _is_integer(v) -> bool:
    """Integer dtype test for numpy arrays and torch tensors alike."""
    if isinstance(v, torch.Tensor):
        return not (v.is_floating_point() or v.is_complex())
    return np.issubdtype(np.dtype(v.dtype), np.integer)


def corrupt_weight(params, factor: float):
    """``weight_corrupt``: the first ``"w"`` tensor, silently wrong.

    Integer (quantized) tensors are sign-flipped — dtype-preserving, so
    the int8 kernel contract still holds and nothing raises; float
    tensors are scaled by ``factor``.  Returns ``params`` unchanged
    (same object) when no weight leaf exists.
    """
    hit = [False]

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "w" and not hit[0]:
                    hit[0] = True
                    out[k] = -v if _is_integer(v) else v * factor
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    corrupted = walk(params)
    return corrupted if hit[0] else params


class StaleCacheFn:
    """``stale_cache``: a compiled callable serving yesterday's answers.

    The first call passes through (nothing stale exists yet); every call
    after returns the PREVIOUS call's output while quietly computing and
    retaining the current one.  All calls to one cache entry share a
    padded bucket shape, so the swap is shape-safe — the caller receives
    real, finite logits that belong to somebody else's events.
    """

    def __init__(self, fn):
        self._fn = fn
        self._last = None

    def __call__(self, x):
        cur = self._fn(x)
        if self._last is None:
            self._last = cur
            return cur
        out, self._last = self._last, cur
        return out


class StuckBuffer:
    """A dispatch result that refuses to become ready until ``ready_at``.

    Duck-types the slice of the port's dispatched-result surface the
    engine's realization path touches — ``is_ready()`` (polled by the
    watchdog), ``synchronize()`` (the blocking path; sleeps out the
    remaining stall so non-watchdog callers still terminate), and
    ``__array__`` / ``shape`` / ``dtype`` for host materialization.
    """

    def __init__(self, inner, ready_at: float, clock=time.monotonic):
        self._inner = inner
        self._ready_at = ready_at
        self._clock = clock

    def is_ready(self) -> bool:
        return self._clock() >= self._ready_at

    def synchronize(self):
        while not self.is_ready():
            time.sleep(0.001)
        return self

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self._inner)
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def shape(self):
        return self._inner.shape

    @property
    def dtype(self):
        return self._inner.dtype

    def __getitem__(self, idx):
        return np.asarray(self)[idx]


class FaultInjector:
    """Holds armed :class:`Fault`\\ s; the engine consults it at seams.

    One injector can be shared by every engine in a degradation ladder
    (the :class:`~repro.serving.resilient.ResilientEngine` threads
    itself through) — path-scoped faults then hit exactly the rung they
    name, which is what makes "primary fails, fallback serves"
    testable.
    """

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self.faults: list[Fault] = []
        self.log: list[tuple] = []       # (seam, path, bucket) per firing

    # -- arming ------------------------------------------------------------

    def arm(self, seam: str, *, path: str | None = None,
            bucket: int | None = None, times: float = math.inf,
            delay_s: float = 0.0, factor: float = 2.0) -> Fault:
        fault = Fault(seam=seam, path=path, bucket=bucket, times=times,
                      delay_s=delay_s, factor=factor)
        self.faults.append(fault)
        return fault

    def disarm(self, fault: Fault | None = None) -> None:
        """Remove one fault (or all of them)."""
        if fault is None:
            self.faults.clear()
        else:
            self.faults.remove(fault)

    def fired(self, seam: str | None = None) -> int:
        """Total firings, optionally restricted to one seam."""
        return sum(1 for s, _, _ in self.log if seam is None or s == seam)

    # -- seams (called by the engine) --------------------------------------

    def _fire(self, seam: str, path, bucket) -> Fault | None:
        for f in self.faults:
            if f.matches(seam, path, bucket):
                f.fired += 1
                self.log.append((seam, path, bucket))
                return f
        return None

    def check(self, seam: str, *, path=None, bucket=None) -> None:
        """``compile`` / ``dispatch`` seam: raise when a fault fires."""
        if self._fire(seam, path, bucket) is not None:
            raise InjectedFault(seam, path=path, bucket=bucket)

    def corrupt_build(self, workload, bucket):
        """``scale_drift`` / ``weight_corrupt`` seams, consulted by
        ``ExecutionCore.compiled_for`` on a cache MISS.

        When an armed silent fault matches and the workload can actually
        be corrupted that way (it exposes a ``corrupted(seam, factor)``
        hook returning a poisoned twin callable, and the corruption
        found something to bite), returns the corrupted compiled
        callable; otherwise ``None`` and the build proceeds normally.
        A fault that does not apply (e.g. ``scale_drift`` on an fp32
        path) neither fires nor burns budget.
        """
        path = getattr(workload, "name", None)
        hook = getattr(workload, "corrupted", None)
        if hook is None:
            return None
        for seam in ("scale_drift", "weight_corrupt"):
            for f in self.faults:
                if f.matches(seam, path, bucket):
                    fn = hook(seam, f.factor, bucket)
                    if fn is not None:
                        f.fired += 1
                        self.log.append((seam, path, bucket))
                        return fn
        return None

    def wrap_stale(self, fn, *, path=None, bucket=None):
        """``stale_cache`` seam: wrap a freshly built cache entry in
        :class:`StaleCacheFn` (previous dispatch's output) when armed."""
        if self._fire("stale_cache", path, bucket) is not None:
            return StaleCacheFn(fn)
        return fn

    def corrupt_input(self, x, *, path=None, bucket=None):
        """``input_nan`` seam: NaN the first event of the chunk."""
        if self._fire("input_nan", path, bucket) is not None:
            x = np.array(x, copy=True)
            x[0] = np.nan
        return x

    def wrap_output(self, out, *, path=None, bucket=None):
        """``output_nan`` / ``stuck`` / ``latency`` seams, applied to the
        freshly dispatched (un-realized) result."""
        f = self._fire("latency", path, bucket)
        if f is not None:
            time.sleep(f.delay_s)
        f = self._fire("output_nan", path, bucket)
        if f is not None:
            return np.full(out.shape, np.nan, np.float32)
        f = self._fire("stuck", path, bucket)
        if f is not None:
            return StuckBuffer(out, self._clock() + f.delay_s, self._clock)
        return out
