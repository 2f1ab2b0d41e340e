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
* **watchdog** — realization with a ``timeout_s`` budget raises
  :class:`WatchdogTimeout` instead of blocking forever;
* **wall-union metrics** — KGPS wall time is the union of dispatch
  windows, recorded into a shared ``ServingMetrics``;
* **fault seams** — an optional ``FaultInjector`` is consulted at the
  compile / dispatch / input / output boundaries.

Where the reference leaned on JAX's runtime, the port uses CUDA's own:
host batches go to the card from a pinned host tensor with a
``non_blocking`` copy on a side stream (the double buffer of
:func:`serve_stream`); a dispatched result carries a ``torch.cuda.Event``
recorded after its work, so readiness is ``Event.query()`` and waiting
is ``Event.synchronize()`` (:class:`DeviceResult`).  No CUDA graph and
no ``torch.compile`` yet: a bucket's callable launches eagerly.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.kernels import autotune
from repro_torch.serving.metrics import ServingMetrics, kgps

# In-flight dispatch depth for chunked infer().
MAX_INFLIGHT_CHUNKS = 4

# Retained merged busy-window intervals for overlap-safe KGPS accounting.
_MAX_WALL_WINDOWS = 64


class WatchdogTimeout(RuntimeError):
    """A dispatched result failed to become ready within the watchdog
    budget (``PendingResult.result(timeout_s=...)``); the resilience
    layer counts it and re-serves via the fallback chain."""


class DeviceResult:
    """A dispatched output tensor and the event recorded after its work.

    The readiness surface the core polls: ``is_ready()`` is the event's
    ``query()`` (always True for a CPU tensor), ``synchronize()`` waits
    on it, and ``__array__`` copies the finished tensor to the host.
    """

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self._event = None
        if tensor.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensor.device))

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def synchronize(self) -> "DeviceResult":
        if self._event is not None:
            self._event.synchronize()
        return self

    def __array__(self, dtype=None, copy=None):
        self.synchronize()
        arr = self.tensor.detach().cpu().numpy()
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


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``: a pinned staging copy and a
    ``non_blocking`` transfer for CUDA, the array's own memory on CPU."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _DoubleBuffer:
    """Two pinned host buffers feeding a CUDA device from a side stream.

    ``put`` copies the next batch into the buffer the previous-but-one
    transfer used (after that transfer finished), starts its H2D copy on
    the copy stream, and makes the compute stream wait for it — so the
    transfer of batch k+1 overlaps the compute of batch k.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._copy_stream = torch.cuda.Stream(device)
        self._bufs = [None, None]
        self._done = [None, None]
        self._k = 0

    def put(self, x: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(x))
        k, self._k = self._k, self._k ^ 1
        buf = self._bufs[k]
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self._bufs[k] = torch.empty(src.shape, dtype=src.dtype,
                                              pin_memory=True)
        elif self._done[k] is not None:
            self._done[k].synchronize()        # its last H2D has finished
        buf.copy_(src)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = buf.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        self._done[k] = done
        compute.wait_event(done)
        dev.record_stream(compute)
        return dev


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

    def cache_key(self, bucket) -> tuple:
        """Everything a bound callable's identity depends on."""
        return (self.name, bucket)

    def build(self, bucket):
        """An async-dispatch callable (device tensor -> device tensor)
        for one bucket shape."""
        raise NotImplementedError

    def pad(self, x: np.ndarray, bucket: int) -> np.ndarray:
        """Pad a request's leading axis up to ``bucket`` rows."""
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


def serve_stream(fwd, stream, *, warmup: int = 2, metrics=None, bucket=None,
                 device="cpu"):
    """Double-buffered device-feed loop; returns (latencies, events, wall).

    ``fwd`` is an async-dispatch callable on device tensors; latencies
    are seconds from host handoff to logits ready.  On CUDA, batch k+1's
    pinned H2D copy is issued on a side stream while batch k computes.
    The first ``warmup`` batches are excluded from the stats; a stream no
    longer than ``warmup`` yields empty stats, not a crash.
    """
    device = torch.device(device)
    put = _DoubleBuffer(device).put if device.type == "cuda" \
        else (lambda a: to_device(a, device))
    latencies = []
    events = 0
    it = iter(stream)
    try:
        nxt = put(next(it))
    except StopIteration:
        return latencies, events, 0.0

    t_start = time.perf_counter() if warmup == 0 else None
    k = 0
    while nxt is not None:
        cur = nxt
        t0 = time.perf_counter()
        out = DeviceResult(fwd(cur))         # async dispatch
        try:
            nxt = put(next(it))              # overlap next H2D with compute
        except StopIteration:
            nxt = None
        out.synchronize()
        t1 = time.perf_counter()
        k += 1
        if k <= warmup:                      # exclude warm-up from stats
            t_start = time.perf_counter()
            continue
        latencies.append(t1 - t0)
        events += cur.shape[0]
        if metrics is not None:
            metrics.record_batch(t1 - t0, cur.shape[0],
                                 bucket or cur.shape[0])
    wall = (time.perf_counter() - t_start) if t_start else 0.0
    return latencies, events, wall


class PendingResult:
    """In-flight inference: dispatched to the device, not yet waited on.

    ``result()`` waits (once), records metrics per chunk, and returns the
    host logits.  Recorded latency is dispatch-to-realization; KGPS wall
    time is overlap-safe in any realization order.
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
        wait blocks in a daemon thread, abandoned with a wedged result."""
        is_ready = getattr(out, "is_ready", None)
        if deadline is None or is_ready is None:
            _synchronize(out)
            return
        if is_ready():
            return
        done = threading.Event()
        threading.Thread(target=lambda: (_synchronize(out), done.set()),
                         daemon=True).start()
        if not done.wait(max(0.0, deadline - time.perf_counter())):
            raise WatchdogTimeout(
                "dispatched result not ready within the watchdog "
                "budget; abandoning the in-flight buffer")

    def result(self, *, timeout_s: float | None = None) -> np.ndarray:
        if self._out is None:
            deadline = (None if timeout_s is None
                        else time.perf_counter() + timeout_s)
            outs = []
            t_first, t_last, events = None, None, 0
            for out, n_valid, bucket, t0 in self._chunks:
                self._wait_ready(out, deadline)
                t1 = time.perf_counter()
                if self._record:
                    self._engine.metrics.record_batch(t1 - t0, n_valid, bucket)
                t_first = t0 if t_first is None else t_first
                t_last, events = t1, events + n_valid
                outs.append(np.asarray(out)[:n_valid])
            if self._record and t_first is not None:
                self._engine._record_wall_window(t_first, t_last, events)
            self._out = np.concatenate(outs, axis=0)
            self._chunks = ()            # free device buffers
        return self._out


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
        self._wall_windows: list[tuple[float, float]] = []
        self._cache: dict[tuple, object] = {}

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
        """Build (and run once) the given buckets before traffic arrives."""
        for b in buckets if buckets is not None else self.bucket_sizes:
            x = to_device(self.workload.placeholder(b), self.device)
            DeviceResult(self.compiled_for(b)(x)).synchronize()

    # -- inference ----------------------------------------------------------

    def _pad(self, x: np.ndarray, bucket: int) -> np.ndarray:
        return self.workload.pad(x, bucket)

    def infer(self, x, *, record: bool = True, sync: bool = True,
              timeout_s: float | None = None):
        """Serve ``x`` (n, ...): pad to bucket, dispatch, slice back.

        Requests larger than the top bucket are chunked through it, with
        at most :data:`MAX_INFLIGHT_CHUNKS` dispatches outstanding.
        ``sync=False`` returns a :class:`PendingResult` right after
        dispatch; metrics are recorded at realization.  ``timeout_s``
        arms the realization watchdog (sync path).
        """
        x = np.asarray(x)
        top = self.bucket_sizes[-1]
        chunks = []
        for i in range(0, x.shape[0], top):
            if len(chunks) >= MAX_INFLIGHT_CHUNKS:
                # throttle: wait for the oldest in-flight chunk first
                _synchronize(chunks[-MAX_INFLIGHT_CHUNKS][0])
            chunk = x[i:i + top]
            n_valid = chunk.shape[0]
            bucket = self.bucket_for(n_valid)
            if self.injector is not None:
                self.injector.check("dispatch", path=self.workload.name,
                                    bucket=bucket)
                chunk = self.injector.corrupt_input(
                    chunk, path=self.workload.name, bucket=bucket)
            fn = self.compiled_for(bucket)
            t0 = time.perf_counter()
            xd = to_device(self._pad(chunk, bucket), self.device)
            out = DeviceResult(fn(xd))                   # async dispatch
            if self.injector is not None:
                out = self.injector.wrap_output(out, path=self.workload.name,
                                                bucket=bucket)
            chunks.append((out, n_valid, bucket, t0))
        pending = PendingResult(self, chunks, record=record)
        return pending.result(timeout_s=timeout_s) if sync else pending

    def run_stream(self, stream, *, warmup: int = 2) -> dict:
        """Pump a fixed-size batch stream through the double-buffered feed
        loop (the trigger CLI's hot path).  All batches share one size;
        each is padded to its ladder bucket before dispatch."""
        stream = list(stream)
        if not stream:
            return {"latencies": [], "events": 0, "wall_s": 0.0,
                    "bucket": None, "kgps": float("nan")}
        sizes = {b.shape[0] for b in stream}
        if len(sizes) != 1:
            raise ValueError(f"stream batches differ in size: {sorted(sizes)}")
        n_valid = sizes.pop()
        if n_valid > self.bucket_sizes[-1]:
            raise ValueError(
                f"stream batch size {n_valid} exceeds the top bucket "
                f"{self.bucket_sizes[-1]}; build the engine with "
                f"max_batch >= {n_valid} or chunk through infer()")
        bucket = self.bucket_for(n_valid)
        fwd = self.compiled_for(bucket)
        padded = [self._pad(np.asarray(b), bucket) for b in stream]
        lat, _, wall = serve_stream(fwd, padded, warmup=warmup,
                                    device=self.device)
        # KGPS counts VALID events only — padding rows are not throughput.
        events = n_valid * len(lat)
        for t in lat:
            self.metrics.record_batch(t, n_valid, bucket)
        self.metrics.record_wall(wall, events)
        return {"latencies": lat, "events": events, "wall_s": wall,
                "bucket": bucket, "kgps": kgps(events, wall)}
