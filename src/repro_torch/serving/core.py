"""Workload-agnostic execution core: the serving fabric's bottom layer.

Port of ``repro.serving.core``.  :class:`ExecutionCore` owns, for any
:class:`Workload`:

* **bound-callable cache** — one callable per bucket, built on a miss
  (fault-injectable at the ``compile`` seam) with the workload's
  weights already split, packed and resident on the device;
* **pad-to-bucket dispatch** — requests padded up the workload's ladder;
* **async in-flight window** — :meth:`ExecutionCore.infer` with
  ``sync=False`` returns a :class:`PendingResult`; oversized requests
  pipeline chunks with at most :data:`MAX_INFLIGHT_CHUNKS` outstanding;
* **stream loop** — :func:`pump_stream` serves a fixed-size batch stream
  through an engine's own ``infer(sync=False)``, at most
  :data:`STREAM_INFLIGHT` results in flight;
* **watchdog** — realization with a ``timeout_s`` budget raises
  :class:`WatchdogTimeout` instead of blocking forever;
* **wall-union metrics** — KGPS wall time is the union of dispatch
  windows, recorded into a shared ``ServingMetrics``;
* **fault seams** — an optional ``FaultInjector`` is consulted at the
  compile / dispatch / input / output boundaries.

Where the reference leaned on JAX's runtime, the port uses CUDA's own,
and every trigger batch reaches the card through
:meth:`ExecutionCore.infer`: each chunk is copied into a reused pinned
slot of the core's :class:`StagingRing` and sent with a
``non_blocking`` copy; its logits come back the same way, a
``non_blocking`` copy into a reused pinned slot of a second ring
enqueued right behind the launch, with the result's ``torch.cuda.Event``
recorded after that copy, so readiness (``Event.query()``) means the
logits are on the host and realizing them reads host memory only
(:class:`DeviceResult`).  No CUDA graph and no ``torch.compile`` yet: a
bucket's callable launches eagerly.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from repro_torch.kernels import autotune
from repro_torch.serving.metrics import ServingMetrics, kgps

# In-flight dispatch depth for chunked infer().
MAX_INFLIGHT_CHUNKS = 4

# Most staging slots a StagingRing keeps for one bucket shape.
MAX_STAGING_SLOTS = 2 * MAX_INFLIGHT_CHUNKS

#: Results :func:`pump_stream` keeps in flight: the next batch is
#: dispatched before the oldest is realized.
STREAM_INFLIGHT = 2

#: The counters StagingRing.fill bumps, one per chunk staged on CUDA: no
#: fault, so checks for a quiet engine leave them out.
STAGING_COUNTERS = ("core.stage_reused", "core.stage_grown",
                    "core.stage_waited")

#: The counters of a chunk's logits on CUDA, no fault either: the output
#: ring's, one a launch (StagingRing.send), and ``core.d2h_early``, one a
#: realize (PendingResult.result) of logits copied into a pinned slot at
#: launch.
D2H_COUNTERS = ("core.d2h_reused", "core.d2h_grown", "core.d2h_waited",
                "core.d2h_early")

# Retained merged busy-window intervals for overlap-safe KGPS accounting.
_MAX_WALL_WINDOWS = 64


class WatchdogTimeout(RuntimeError):
    """A dispatched result failed to become ready within the watchdog
    budget (``PendingResult.result(timeout_s=...)``); the resilience
    layer counts it and re-serves via the fallback chain."""


class DeviceResult:
    """A dispatched output tensor and the way its logits reach the host.

    A CUDA tensor's copy into a pinned slot of ``ring`` (the core's
    output ring) is enqueued at once, on the current stream right behind
    the work that writes the tensor, and an event is recorded after that
    copy (:meth:`StagingRing.send`; ``count`` takes the ring's counters):
    ``is_ready()`` then means the logits are on the host, and
    ``__array__`` copies them out of the slot without touching the card.
    A CPU tensor is already on the host: it is always ready.
    ``synchronize()`` waits for the copy.
    """

    def __init__(self, tensor: torch.Tensor, ring=None, count=None):
        self.tensor = tensor
        self._ring = ring
        self._claim = None
        if tensor.is_cuda:
            self._claim = ring.send(
                tensor, torch.cuda.current_stream(tensor.device), count)

    @property
    def d2h(self) -> str | None:
        """``"early"``: the logits were copied into a pinned slot at
        launch; None for a CPU tensor, already on the host."""
        return None if self._claim is None else "early"

    def is_ready(self) -> bool:
        return self._claim is None or self._claim.copied.query()

    def synchronize(self) -> "DeviceResult":
        if self._claim is not None:
            self._claim.copied.synchronize()
        return self

    def abandon(self) -> None:
        """The caller gives up on this result (a watchdog timeout): its
        slot, whose copy may still land, leaves the ring for good."""
        if self._claim is not None:
            self._ring.drop(self._claim)

    def __array__(self, dtype=None, copy=None):
        if self._claim is not None:
            arr = self._claim.synchronize()
        else:
            arr = self.tensor.detach().numpy()
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def shape(self):
        return tuple(self.tensor.shape)


def _synchronize(out) -> None:
    """Wait for ``out`` (results without a ``synchronize`` — host arrays —
    are already there)."""
    sync = getattr(out, "synchronize", None)
    if sync is not None:
        sync()


def stage(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> the host tensor the copy to ``device`` reads: a
    pinned staging copy for CUDA, the array's own memory otherwise."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.pin_memory() if device.type == "cuda" else t


def h2d(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A staged host tensor on ``device``: a ``non_blocking`` transfer for
    CUDA, the tensor itself otherwise."""
    return t.to(device, non_blocking=True) if device.type == "cuda" else t


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` (:func:`stage`, then :func:`h2d`)."""
    return h2d(stage(x, device), device)


class _Slot:
    """One pinned host buffer of a bucket's shape.  Staged: rows ``[rows,
    bucket)`` are zero, and ``event`` completes when its last copy to the
    card has.  Sent: ``event`` is the :class:`_Claim` of the chunk whose
    logits it holds."""

    __slots__ = ("key", "tensor", "array", "rows", "event")

    def __init__(self, key, tensor: torch.Tensor, event):
        self.key = key
        self.tensor = tensor
        self.array = tensor.numpy()
        self.rows = 0
        self.event = event


class _Claim:
    """One chunk's logits in an output slot, and the slot's ``event`` in
    its ring until the slot is taken again: done once the rows are out.

    ``copied`` is recorded after the copy into the slot.  Waiting on the
    claim (the chunk's realize, or the ring's wait at its limit) waits
    on ``copied`` and copies the rows into an array of their own, once;
    from then on the slot is free and the rows live in ``rows``."""

    __slots__ = ("slot", "copied", "rows", "_lock")

    def __init__(self, slot: _Slot, copied):
        self.slot = slot
        self.copied = copied
        self.rows = None
        self._lock = threading.Lock()

    def record(self, stream) -> None:
        self.copied.record(stream)

    def query(self) -> bool:
        return self.rows is not None

    def synchronize(self) -> np.ndarray:
        with self._lock:
            if self.rows is None:
                self.copied.synchronize()
                self.rows = self.slot.array.copy()
            return self.rows


class StagingRing:
    """Reused pinned host slots for the copies between host and card.

    A slot is allocated once (pinned unless ``pin`` is False) and keyed
    by its shape and dtype.  Staging: a slot has a bucket's full shape
    and the chunk's trailing shape and dtype, zeroed at first.
    :meth:`fill` copies a chunk's rows into a free slot in one copy and
    zeroes only the pad rows that still hold an earlier chunk's, so that
    the slot equals ``Workload.pad(chunk, bucket)``; :meth:`release`
    hands it back once its copy to the card is enqueued, recording the
    slot's event (from ``new_event``) on that copy's stream.  Sending:
    :meth:`send` enqueues a device tensor's copy into a free slot of its
    shape and hands the slot back at once, its event a :class:`_Claim`
    that is done only when the rows have been copied out of the slot
    again; :meth:`drop` takes the slot of a result given up on out of
    the ring.

    A slot is free only when its event has completed: the oldest slot is
    reused if free; else the ring grows, up to ``limit`` slots a shape;
    past that it waits on the oldest slot's event (for a sent slot: its
    copy, and the move of its rows into an array of their own).  Each
    fill or send counts ``<counter>reused``, ``<counter>grown`` or
    ``<counter>waited`` through the ``count`` it is given.  Thread-safe:
    a slot being filled is out of the ring until it is released, so two
    threads never share one.
    """

    def __init__(self, *, limit: int = MAX_STAGING_SLOTS, pin: bool = True,
                 new_event=torch.cuda.Event, counter: str = "core.stage_"):
        self._limit = limit
        self._pin = pin
        self._new_event = new_event
        self._counter = counter
        self._lock = threading.Lock()
        self._ring: dict[tuple, collections.deque] = {}  # oldest first
        self._size: collections.Counter = collections.Counter()

    def _take(self, key, count) -> _Slot | None:
        """The slot to fill for ``key`` (None: grow the ring), counted."""
        with self._lock:
            ring = self._ring.setdefault(key, collections.deque())
            if ring and ring[0].event.query():
                how, slot = "reused", ring.popleft()
            elif self._size[key] < self._limit or not ring:
                how, slot = "grown", None
                self._size[key] += 1
            else:
                how, slot = "waited", ring.popleft()
        count(self._counter + how)
        if how == "waited":
            slot.event.synchronize()
        return slot

    def fill(self, chunk: np.ndarray, bucket: int, count) -> _Slot:
        """A slot holding ``chunk``'s rows, its other rows zero; ``count``
        (e.g. ``ServingMetrics.incr``) takes the name of how it was got."""
        key = (bucket, chunk.shape[1:], chunk.dtype)
        slot = self._take(key, count)
        if slot is None:
            dtype = torch.from_numpy(np.empty(0, chunk.dtype)).dtype
            slot = _Slot(key, torch.empty((key[0], *key[1]), dtype=dtype,
                                          pin_memory=self._pin).zero_(),
                         self._new_event())
        n = chunk.shape[0]
        np.copyto(slot.array[:n], chunk)
        if slot.rows > n:
            slot.array[n:slot.rows] = 0
        slot.rows = n
        return slot

    def release(self, slot: _Slot, stream=None) -> None:
        """Hand ``slot`` back after its copy to the card is enqueued on
        ``stream``: its event, recorded there, guards its next fill.  A
        slot never released (its copy failed) is never reused."""
        slot.event.record(stream)
        with self._lock:
            self._ring[slot.key].append(slot)

    def send(self, t: torch.Tensor, stream, count) -> _Claim:
        """Enqueue ``t``'s ``non_blocking`` copy into a free slot of its
        shape and dtype, on ``stream``, the current stream of ``t``'s
        device, which its writer ran on; the claim's ``copied`` is
        recorded there after the copy."""
        key = (tuple(t.shape), t.dtype)
        slot = self._take(key, count)
        if slot is None:
            slot = _Slot(key, torch.empty(key[0], dtype=t.dtype,
                                          pin_memory=self._pin), None)
        slot.tensor.copy_(t.detach(), non_blocking=True)
        slot.event = claim = _Claim(slot, self._new_event())
        self.release(slot, stream)
        return claim

    def drop(self, claim: _Claim) -> None:
        """Take ``claim``'s slot out of the ring for good if it still holds
        that claim's rows: a copy that may still land is never overwritten
        by, or read as, another chunk's."""
        slot = claim.slot
        with self._lock:
            ring = self._ring.get(slot.key, ())
            if slot.event is claim and slot in ring:
                ring.remove(slot)
                self._size[slot.key] -= 1


class Workload:
    """What a workload declares for :class:`ExecutionCore` to serve it:
    its bound callable per bucket, its input shape discipline and its
    bucket policy.  ``name`` labels cache keys, fault seams and metrics.
    """

    name: str = "workload"
    device: torch.device = torch.device("cpu")

    def bucket_ladder(self, max_batch: int) -> list[int]:
        """The pad-to-bucket ladder this workload earns for ``max_batch``."""
        raise NotImplementedError

    def validate_buckets(self, bucket_sizes: list[int]) -> None:
        """Veto a ladder the workload cannot serve (e.g. a bucket that
        does not divide its data-parallel shards).  Default: anything
        goes."""

    def cache_key(self, bucket) -> tuple:
        """Everything a bound callable's identity depends on."""
        return (self.name, bucket)

    def build(self, bucket):
        """An async-dispatch callable (device tensor -> device tensor)
        for one bucket shape."""
        raise NotImplementedError

    def pad(self, x: np.ndarray, bucket: int) -> np.ndarray:
        """Pad a request's leading axis up to ``bucket`` rows with zeros.
        On CUDA, :meth:`ExecutionCore.infer` stages these same bytes into
        a reused slot of its :class:`StagingRing` without calling this."""
        n = x.shape[0]
        if n == bucket:
            return x
        return np.concatenate(
            [x, np.zeros((bucket - n, *x.shape[1:]), x.dtype)], axis=0)

    def placeholder(self, bucket: int) -> np.ndarray:
        """A zero input of the bucket's shape (for :meth:`ExecutionCore.warm`)."""
        raise NotImplementedError

    def corrupted(self, seam: str, factor: float, bucket):
        """A callable built from silently corrupted params for the
        ``scale_drift`` / ``weight_corrupt`` seams, or ``None`` when the
        corruption does not apply."""
        return None


class PendingResult:
    """In-flight inference: dispatched to the device, not yet waited on.

    ``result()`` waits (once), records metrics per chunk, and returns the
    host logits.  Recorded latency is dispatch-to-realization; KGPS wall
    time is overlap-safe in any realization order.  Each chunk's wait
    (on CUDA, for its copy into a pinned slot) and the copy of its rows
    into host memory of their own are the spans ``core.wait`` and
    ``core.d2h``; each chunk whose logits were copied into a pinned slot
    at launch (:attr:`DeviceResult.d2h`) counts ``core.d2h_early``.  A
    chunk given up on at the watchdog's deadline, and every chunk after
    it, is abandoned (:meth:`DeviceResult.abandon`).
    """

    def __init__(self, engine, chunks, *, record: bool = True):
        self._engine = engine
        self._chunks = chunks            # [(result, n_valid, bucket, t0)]
        self._record = record
        self._out = None

    @property
    def ready(self) -> bool:
        """True when every dispatched chunk is done (non-blocking)."""
        return all(getattr(c[0], "is_ready", lambda: True)()
                   for c in self._chunks)

    @staticmethod
    def _wait_ready(out, deadline: float | None) -> None:
        """Block until ``out`` is ready; past a ``deadline`` (absolute
        ``perf_counter`` time) raise :class:`WatchdogTimeout`.  The timed
        wait polls ``is_ready()`` on the calling thread, as the event's
        own ``synchronize()`` spins, with nothing between polls: a sleep,
        a yield or a release of the interpreter lock there returns late
        now and then, by a millisecond or more on a host with coarse
        timers.  Other Python threads get the lock at the interpreter's
        switch interval."""
        is_ready = getattr(out, "is_ready", None)
        if deadline is None or is_ready is None:
            _synchronize(out)
            return
        while not is_ready():
            if time.perf_counter() >= deadline:
                raise WatchdogTimeout(
                    "dispatched result not ready within the watchdog "
                    "budget; abandoning the in-flight buffer")

    def result(self, *, timeout_s: float | None = None) -> np.ndarray:
        if self._out is None:
            deadline = (None if timeout_s is None
                        else time.perf_counter() + timeout_s)
            outs = []
            t_first, t_last, events = None, None, 0
            metrics = self._engine.metrics
            span = metrics.span
            for k, (out, n_valid, bucket, t0) in enumerate(self._chunks):
                with span("core.wait"):
                    try:
                        self._wait_ready(out, deadline)
                    except WatchdogTimeout:
                        for c in self._chunks[k:]:
                            getattr(c[0], "abandon", lambda: None)()
                        raise
                t1 = time.perf_counter()
                if self._record:
                    metrics.record_batch(t1 - t0, n_valid, bucket)
                t_first = t0 if t_first is None else t_first
                t_last, events = t1, events + n_valid
                with span("core.d2h"):
                    outs.append(np.asarray(out)[:n_valid])
                how = getattr(out, "d2h", None)
                if how is not None:
                    metrics.incr("core.d2h_" + how)
            if self._record and t_first is not None:
                self._engine._record_wall_window(t_first, t_last, events)
            self._out = np.concatenate(outs, axis=0)
            self._chunks = ()            # free device buffers
        return self._out


class PendingPlan:
    """A dispatched :class:`~repro_torch.serving.batcher.BatchPlan` awaiting
    realization: ``result()`` blocks and reassembles per-request logits."""

    def __init__(self, pending: PendingResult, requests):
        self._pending = pending
        self._requests = requests

    @property
    def ready(self) -> bool:
        return self._pending.ready

    def result(self, *, timeout_s: float | None = None) -> dict:
        logits = self._pending.result(timeout_s=timeout_s)
        out: dict[int, list] = {}
        for rid, start, stop in self._requests:
            out.setdefault(rid, []).append(logits[start:stop])
        return {rid: np.concatenate(parts, axis=0)
                for rid, parts in out.items()}


class ExecutionCore:
    """Bucketed, metered, fault-injectable execution over one workload."""

    def __init__(self, workload: Workload, *, bucket_sizes=None,
                 max_batch: int = 1024,
                 metrics: ServingMetrics | None = None, injector=None):
        self.workload = workload
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.injector = injector        # fault seams; None in production
        if bucket_sizes is None:
            bucket_sizes = workload.bucket_ladder(max_batch)
        self.bucket_sizes = sorted(int(b) for b in bucket_sizes)
        workload.validate_buckets(self.bucket_sizes)
        self._wall_windows: list[tuple[float, float]] = []
        self._cache: dict[tuple, object] = {}
        # CUDA only: on the CPU, h2d hands the kernel the host tensor
        # itself, which a reused slot would alias, and an output is
        # already in host memory.
        on_card = self.device.type == "cuda"
        self._staging = StagingRing() if on_card else None
        self._outputs = StagingRing(counter="core.d2h_") if on_card \
            else None

    @property
    def device(self) -> torch.device:
        return self.workload.device

    # -- bound-callable cache ----------------------------------------------

    def compiled_for(self, bucket):
        """The cached bound callable for one bucket shape (built on miss)."""
        key = self.workload.cache_key(bucket)
        fn = self._cache.get(key)
        if fn is None:
            if self.injector is not None:
                # compile seam: fires only on a cache MISS
                self.injector.check("compile", path=self.workload.name,
                                    bucket=bucket)
                fn = self.injector.corrupt_build(self.workload, bucket)
            if fn is None:
                fn = self.workload.build(bucket)
            if self.injector is not None:
                fn = self.injector.wrap_stale(
                    fn, path=self.workload.name, bucket=bucket)
            self._cache[key] = fn
        return fn

    def evict(self, bucket) -> None:
        """Drop one bucket's cached callable (and the packed weights it
        holds) so the next dispatch rebuilds it from the source params.
        The sentinel's quarantine calls this on a silent-corruption trip:
        a poisoned entry is rebuilt, never re-trusted."""
        self._cache.pop(self.workload.cache_key(bucket), None)

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def _record_wall_window(self, t0: float, t1: float, events: int) -> None:
        """Record ``events`` over the part of [t0, t1] not already counted
        (the union of busy windows: never double-counted, never dropped)."""
        segs = [(t0, t1)]
        for s, e in self._wall_windows:        # subtract existing coverage
            nxt = []
            for a, b in segs:
                if e <= a or s >= b:
                    nxt.append((a, b))
                    continue
                if a < s:
                    nxt.append((a, s))
                if e < b:
                    nxt.append((e, b))
            segs = nxt
        self._wall_windows.append((t0, t1))
        self._wall_windows.sort()
        merged = []
        for s, e in self._wall_windows:        # compact
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        self._wall_windows = merged[-_MAX_WALL_WINDOWS:]
        self.metrics.record_wall(sum(b - a for a, b in segs), events)

    def bucket_for(self, n_events: int) -> int:
        """Smallest bucket holding ``n_events`` (largest if none do)."""
        return autotune.bucket_for(self.bucket_sizes, n_events)

    def warm(self, buckets=None) -> None:
        """Build (and run once) the given buckets before traffic arrives,
        each output through a slot of the output ring, which keeps it."""
        for b in buckets if buckets is not None else self.bucket_sizes:
            x = to_device(self.workload.placeholder(b), self.device)
            np.asarray(DeviceResult(self.compiled_for(b)(x), self._outputs,
                                    self.metrics.incr))

    # -- inference ----------------------------------------------------------

    def infer(self, x, *, record: bool = True, sync: bool = True,
              timeout_s: float | None = None, bucket: int | None = None):
        """Serve ``x`` (n, ...): pad to bucket, dispatch, slice back.

        Requests larger than the top bucket are chunked through it, with
        at most :data:`MAX_INFLIGHT_CHUNKS` dispatches outstanding.
        ``sync=False`` returns a :class:`PendingResult` right after
        dispatch; metrics are recorded at realization.  ``timeout_s``
        arms the realization watchdog (sync path).  ``bucket`` pins the
        bucket instead of resolving it from the row count: the sentinel's
        canaries ride one bucket's cached callable with a small batch.
        On CUDA a chunk is staged by one copy into a reused pinned slot of
        the core's :class:`StagingRing`, whose event, recorded right after
        the slot's ``non_blocking`` copy to the card, keeps it from being
        refilled early; on the CPU it is padded (:meth:`Workload.pad`).
        On CUDA its output's copy into a pinned slot of the output ring
        is enqueued right behind the launch (:class:`DeviceResult`).
        Each chunk's host batch (the copy into its slot, or the pad), its
        copy to the device, and its launch with the output's copy and
        event are the spans ``core.stage``, ``core.h2d`` and
        ``core.launch``.
        """
        x = np.asarray(x)
        pin = bucket
        if pin is not None:
            if pin not in self.bucket_sizes:
                raise ValueError(
                    f"pinned bucket {pin} not in ladder {self.bucket_sizes}")
            if x.shape[0] > pin:
                raise ValueError(
                    f"request of {x.shape[0]} rows cannot ride pinned "
                    f"bucket {pin}")
        top = self.bucket_sizes[-1]
        span = self.metrics.span
        chunks = []
        for i in range(0, x.shape[0], top):
            if len(chunks) >= MAX_INFLIGHT_CHUNKS:
                # throttle: wait for the oldest in-flight chunk first
                _synchronize(chunks[-MAX_INFLIGHT_CHUNKS][0])
            chunk = x[i:i + top]
            n_valid = chunk.shape[0]
            bucket = self.bucket_for(n_valid) if pin is None else pin
            if self.injector is not None:
                self.injector.check("dispatch", path=self.workload.name,
                                    bucket=bucket)
                chunk = self.injector.corrupt_input(
                    chunk, path=self.workload.name, bucket=bucket)
            fn = self.compiled_for(bucket)
            t0 = time.perf_counter()
            ring = self._staging
            if ring is None:
                with span("core.stage"):
                    xh = stage(self.workload.pad(chunk, bucket),
                               self.device)
                with span("core.h2d"):
                    xd = h2d(xh, self.device)
            else:
                with span("core.stage"):
                    slot = ring.fill(chunk, bucket, self.metrics.incr)
                with span("core.h2d"):
                    xd = h2d(slot.tensor, self.device)
                ring.release(slot, torch.cuda.current_stream(self.device))
            with span("core.launch"):
                out = DeviceResult(fn(xd), self._outputs,  # async dispatch
                                   self.metrics.incr)
            if self.injector is not None:
                out = self.injector.wrap_output(out, path=self.workload.name,
                                                bucket=bucket)
            chunks.append((out, n_valid, bucket, t0))
        pending = PendingResult(self, chunks, record=record)
        return pending.result(timeout_s=timeout_s) if sync else pending

    def run_plan(self, plan, *, sync: bool = True):
        """Execute one :class:`~repro_torch.serving.batcher.BatchPlan`;
        returns ``{rid: (n_i, ...) outputs}`` reassembled per request.
        ``sync=False`` returns a :class:`PendingPlan` right after dispatch."""
        pending = PendingPlan(self.infer(plan.x, sync=False), plan.requests)
        return pending.result() if sync else pending

    def run_stream(self, stream, *, warmup: int = 2) -> dict:
        """Serve a fixed-size batch stream (:func:`pump_stream`)."""
        return pump_stream(self, stream, warmup=warmup)


def pump_stream(engine, stream, *, warmup: int = 2) -> dict:
    """Serve a stream of equal-size batches through ``engine.infer(x,
    sync=False)`` (an :class:`ExecutionCore` or a ``ResilientEngine``),
    the trigger CLI's hot path: a batch is dispatched once fewer than
    :data:`STREAM_INFLIGHT` are in flight, the oldest realized first.

    The first ``warmup`` batches are served with ``record=False``; the
    engine records the others itself, each batch's latency and the
    wall-union KGPS, as on any ``infer``.  Returns ``latencies`` (seconds
    from the call into the engine to the logits on the host, recorded
    batches only), ``events`` (their valid rows; padding is not
    throughput), ``wall_s`` (first recorded call to last logits),
    ``bucket`` and ``kgps``.  A stream no longer than ``warmup`` gives
    empty stats and KGPS nan.
    """
    stream = list(stream)
    if not stream:
        return {"latencies": [], "events": 0, "wall_s": 0.0,
                "bucket": None, "kgps": float("nan")}
    sizes = {b.shape[0] for b in stream}
    if len(sizes) != 1:
        raise ValueError(f"stream batches differ in size: {sorted(sizes)}")
    n_valid = sizes.pop()
    top = engine.bucket_sizes[-1]
    if n_valid > top:
        raise ValueError(
            f"stream batch size {n_valid} exceeds the top bucket {top}; "
            f"build the engine with max_batch >= {n_valid} or chunk "
            "through infer()")
    pend: collections.deque = collections.deque()
    latencies = []

    def realize() -> None:
        t_call, pending, record = pend.popleft()
        pending.result()
        if record:
            latencies.append(time.perf_counter() - t_call)

    t_first = None
    for k, x in enumerate(stream):
        if len(pend) >= STREAM_INFLIGHT:
            realize()
        record = k >= warmup
        t_call = time.perf_counter()
        if record and t_first is None:
            t_first = t_call
        pend.append((t_call, engine.infer(x, record=record, sync=False),
                     record))
    while pend:
        realize()
    wall = 0.0 if t_first is None else time.perf_counter() - t_first
    events = n_valid * len(latencies)
    return {"latencies": latencies, "events": events, "wall_s": wall,
            "bucket": engine.bucket_for(n_valid),
            "kgps": kgps(events, wall)}
