"""Fault-tolerant serving: degradation ladder, shedding, health.

Port of ``repro.serving.resilient``.  :class:`ResilientEngine` wraps one
:class:`~repro_torch.serving.engine.ServingEngine` per rung of the
forward path's fallback chain
(:func:`repro_torch.core.paths.fallback_chain`, e.g. ``int8_fused_full
-> fused_full -> sr_split``) and guarantees the serve loop never raises:

* **degradation ladder** — a rung that fails to build or launch,
  produces non-finite outputs, or wedges past the watchdog is demoted
  *per bucket*; the request is re-served on the next rung down,
  bottoming out in the chain's plain PyTorch reference.
* **exponential-backoff re-promotion** — a demoted bucket probes the
  ladder top again (first after ``probe_initial_s``, doubling to
  ``probe_max_s``); a healthy probe re-promotes.
* **deadline shedding** — a request already past its deadline is shed
  before dispatch (counted, never served).
* **bounded in-flight queue** — at most ``max_inflight`` async
  dispatches; a full queue realizes the oldest first.
* **watchdog** — realization waits at most ``watchdog_s``; a timeout
  demotes the rung and re-serves on the fallback.
* **health** — ``healthy / degraded / shedding / down`` with per-bucket
  detail (:meth:`ResilientEngine.health`), from the shared metrics
  counters.

A demotion hides a failing kernel from the caller by design, so every
one is counted in ``health()["counters"]``; ``chip_smoke.py`` fails on
any.  Not ported yet: the silent-corruption sentinel (``sentinel`` must
be ``None``) and the deadline batcher's ``run_plan``.  Every transition
is injectable (:mod:`repro_torch.serving.faults`), so the ladder is
unit-testable on the CPU.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core import paths as forward_paths
from repro_torch.serving.engine import ServingEngine, WatchdogTimeout
from repro_torch.serving.faults import InjectedFault
from repro_torch.serving.metrics import ServingMetrics

#: Health states, worst wins.
HEALTH_STATES = ("healthy", "degraded", "shedding", "down")


class NonFiniteOutput(RuntimeError):
    """A rung returned NaN/Inf logits — numerics failure, demote."""


class _BucketState:
    """Ladder position + probe schedule for one bucket."""

    __slots__ = ("level", "backoff_s", "next_probe", "demotions", "down")

    def __init__(self, level: int, backoff_s: float):
        self.level = level           # active chain index (0 = primary)
        self.backoff_s = backoff_s   # current probe backoff
        self.next_probe: float | None = None   # absolute clock time
        self.demotions = 0
        self.down = False            # last serve exhausted the ladder


class ResilientPending:
    """Async handle with realization-time recovery: a fault surfacing at
    ``result()`` is counted, demotes the rung, and the request is
    re-served down the ladder — the caller sees logits either way."""

    def __init__(self, engine: "ResilientEngine", x, bucket: int,
                 level: int, pending, record: bool):
        self._engine = engine
        self._x = x
        self._bucket = bucket
        self._level = level
        self._pending = pending
        self._record = record
        self._out = None
        self._done = False

    @property
    def ready(self) -> bool:
        return self._done or self._pending.ready

    def result(self) -> np.ndarray:
        if not self._done:
            self._out = self._engine._realize(
                self, self._pending, self._x, self._bucket, self._level,
                record=self._record)
            self._done = True
            self._pending = None     # free device buffers
        return self._out


class ResilientEngine:
    """Never-raise serving over a forward path's degradation ladder."""

    def __init__(self, params, cfg, *, forward: str = "fused_full",
                 device="cuda", bucket_sizes=None, max_batch: int = 1024,
                 metrics: ServingMetrics | None = None, injector=None,
                 watchdog_s: float | None = 30.0, max_inflight: int = 8,
                 probe_initial_s: float = 0.25, probe_max_s: float = 60.0,
                 shed_window_s: float = 5.0, clock=time.monotonic,
                 sentinel=None):
        if sentinel is not None:
            raise NotImplementedError(
                "the silent-corruption sentinel is not ported yet; "
                "pass sentinel=None")
        self.chain = forward_paths.fallback_chain(forward)
        self.cfg = cfg
        self.forward = forward
        self._engines = {}
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.injector = injector
        self.watchdog_s = watchdog_s
        self.max_inflight = int(max_inflight)
        self.probe_initial_s = float(probe_initial_s)
        self.probe_max_s = float(probe_max_s)
        self.shed_window_s = float(shed_window_s)
        self._clock = clock
        self._params = params        # RAW params: each rung's spec applies
        self._device = device        # its own transform at construction
        self._max_batch = int(max_batch)
        self._construct_failed: set[int] = set()
        self._inflight: list[ResilientPending] = []
        self._last_shed: float | None = None
        self._last_down: float | None = None

        # The base rung is the first CONSTRUCTIBLE chain level; its ladder
        # is the bucket set every other rung is built with.
        base, err = None, None
        for lvl in range(len(self.chain)):
            try:
                eng = ServingEngine(
                    params, cfg, forward=self.chain[lvl], device=device,
                    bucket_sizes=bucket_sizes, max_batch=max_batch,
                    metrics=self.metrics, injector=injector)
            except Exception as e:    # noqa: BLE001 — rung skip, counted
                self._construct_failed.add(lvl)
                self.metrics.incr("construct_failures")
                err = e
                continue
            base, self._engines[lvl] = lvl, eng
            break
        if base is None:
            raise RuntimeError(
                f"no rung of fallback chain {self.chain} is constructible "
                f"for this config; last error: {err!r}") from err
        self._base_level = base
        self.bucket_sizes = self._engines[base].bucket_sizes
        self._state: dict[int, _BucketState] = {}

    # -- introspection -------------------------------------------------------

    @property
    def metrics(self) -> ServingMetrics:
        return self._metrics

    @metrics.setter
    def metrics(self, m: ServingMetrics) -> None:
        # every rung records into ONE shared metrics object
        self._metrics = m
        for eng in self._engines.values():
            eng.metrics = m

    @property
    def n_shards(self) -> int:
        return 1

    @property
    def device(self):
        return self._engines[self._base_level].device

    def bucket_for(self, n_events: int) -> int:
        return self._engines[self._base_level].bucket_for(n_events)

    def active_path(self, bucket: int) -> str:
        """The chain rung currently serving ``bucket``."""
        return self.chain[self._bucket_state(bucket).level]

    def health(self) -> dict:
        """The health state machine's current view: ``down`` (some
        bucket's whole ladder failed on its last serve), ``shedding``
        (sheds within ``shed_window_s``), ``degraded`` (some bucket off
        its primary rung), else ``healthy``; plus per-bucket detail and
        the metrics counters and gauges."""
        now = self._clock()
        buckets = {}
        for b in sorted(self._state):
            st = self._state[b]
            buckets[b] = {
                "path": self.chain[st.level],
                "level": st.level,
                "demotions": st.demotions,
                "down": st.down,
                "next_probe_in_s": (
                    None if st.next_probe is None
                    else max(0.0, st.next_probe - now)),
            }
        recent = (self._last_shed is not None
                  and now - self._last_shed < self.shed_window_s)
        if any(st.down for st in self._state.values()):
            state = "down"
        elif recent:
            state = "shedding"
        elif any(st.level > self._base_level
                 for st in self._state.values()):
            state = "degraded"
        else:
            state = "healthy"
        return {"state": state, "chain": list(self.chain),
                "base_path": self.chain[self._base_level],
                "buckets": buckets, "inflight": len(self._inflight),
                "counters": self.metrics.counters,
                "gauges": self.metrics.gauges}

    # -- rung management -----------------------------------------------------

    def _engine_for(self, level: int) -> ServingEngine:
        if level in self._construct_failed:
            raise RuntimeError(
                f"rung {self.chain[level]!r} permanently skipped "
                "(construction failed)")
        eng = self._engines.get(level)
        if eng is None:
            try:
                eng = ServingEngine(
                    self._params, self.cfg, forward=self.chain[level],
                    device=self._device, bucket_sizes=self.bucket_sizes,
                    max_batch=self._max_batch, metrics=self.metrics,
                    injector=self.injector)
            except Exception:
                self._construct_failed.add(level)
                self.metrics.incr("construct_failures")
                raise
            self._engines[level] = eng
        return eng

    def _bucket_state(self, bucket: int) -> _BucketState:
        st = self._state.get(bucket)
        if st is None:
            st = self._state[bucket] = _BucketState(
                self._base_level, self.probe_initial_s)
        return st

    def _start_level(self, st: _BucketState, now: float) -> int:
        """Where this serve enters the ladder: the active rung, or the
        ladder top when the bucket's re-promotion probe is due."""
        if (st.level > self._base_level and st.next_probe is not None
                and now >= st.next_probe):
            self.metrics.incr("probes")
            return self._base_level
        return st.level

    def _count_failure(self, exc: Exception) -> None:
        if isinstance(exc, InjectedFault) and exc.seam == "compile":
            self.metrics.incr("compile_failures")
        elif isinstance(exc, WatchdogTimeout):
            self.metrics.incr("watchdog_timeouts")
        elif isinstance(exc, NonFiniteOutput):
            self.metrics.incr("nonfinite_batches")
        else:
            # real build/launch errors land here with dispatch failures
            self.metrics.incr("dispatch_failures")

    def _rung_failed(self, st: _BucketState, level: int, now: float,
                     exc: Exception) -> None:
        """One failed serve attempt at ``level``: demote below it (if not
        already) and schedule the next probe with exponential backoff."""
        self._count_failure(exc)
        demote_to = min(level + 1, len(self.chain) - 1)
        if demote_to > st.level:
            st.level = demote_to
            st.demotions += 1
            self.metrics.incr("demotions")
        st.next_probe = now + st.backoff_s
        st.backoff_s = min(st.backoff_s * 2, self.probe_max_s)

    def _rung_served(self, st: _BucketState, level: int) -> None:
        st.down = False
        if level < st.level:         # successful probe: re-promote
            st.level = level
            st.backoff_s = self.probe_initial_s
            st.next_probe = None
            self.metrics.incr("promotions")
        if level > self._base_level:
            self.metrics.incr("fallback_batches")

    def _serve_once(self, level: int, x, *, record: bool) -> np.ndarray:
        out = self._engine_for(level).infer(
            x, record=record, timeout_s=self.watchdog_s)
        if not np.isfinite(out).all():
            raise NonFiniteOutput(
                f"rung {self.chain[level]!r} returned non-finite logits")
        return out

    def _last_resort(self, n: int) -> np.ndarray:
        """Every rung failed: return NaN logits and mark the engine down."""
        self.metrics.incr("failed_requests")
        self._last_down = self._clock()
        n_targets = getattr(self.cfg, "n_targets", 1)
        return np.full((n, n_targets), np.nan, np.float32)

    def _serve_ladder(self, x, *, record: bool = True,
                      start: int | None = None) -> np.ndarray:
        """Serve ``x`` trying rungs from ``start`` (default: the probe /
        active decision) downward.  Never raises."""
        x = np.asarray(x)
        bucket = self.bucket_for(min(x.shape[0], self.bucket_sizes[-1]))
        st = self._bucket_state(bucket)
        lvl = self._start_level(st, self._clock()) if start is None \
            else start
        while lvl < len(self.chain):
            if lvl in self._construct_failed:
                lvl += 1
                continue
            try:
                out = self._serve_once(lvl, x, record=record)
            except Exception as e:   # noqa: BLE001 — ladder catches all
                self._rung_failed(st, lvl, self._clock(), e)
                lvl += 1
                continue
            self._rung_served(st, lvl)
            return out
        st.down = True
        return self._last_resort(x.shape[0])

    # -- serving API ---------------------------------------------------------

    def _shed(self, n_events: int) -> None:
        self.metrics.incr("shed_requests")
        self.metrics.incr("shed_events", n_events)
        self._last_shed = self._clock()

    def _gauge_inflight(self) -> None:
        self.metrics.gauge("inflight", len(self._inflight))

    def warm(self, buckets=None) -> None:
        """Pre-serve zeros through every bucket (builds, and any build-time
        demotion, happen before traffic arrives)."""
        c = self.cfg
        for b in buckets if buckets is not None else self.bucket_sizes:
            self._serve_ladder(
                np.zeros((b, c.n_objects, c.n_features), np.float32),
                record=False)

    def infer(self, x, *, deadline: float | None = None, record: bool = True,
              sync: bool = True):
        """Serve ``x`` through the ladder; never raises.

        ``deadline`` is an absolute time on this engine's clock; a request
        already past it is shed and ``None`` returned.  ``sync=False``
        returns a :class:`ResilientPending`; at most ``max_inflight`` are
        outstanding (a full queue realizes the oldest first).
        """
        x = np.asarray(x)
        if deadline is not None and self._clock() >= deadline:
            self._shed(x.shape[0])
            return None
        if sync:
            return self._serve_ladder(x, record=record)

        while len(self._inflight) >= self.max_inflight:
            self._inflight[0].result()   # realization removes it
            if deadline is not None and self._clock() >= deadline:
                self._shed(x.shape[0])   # expired while backpressured
                return None
        bucket = self.bucket_for(min(x.shape[0], self.bucket_sizes[-1]))
        st = self._bucket_state(bucket)
        lvl = self._start_level(st, self._clock())
        pending = None
        while lvl < len(self.chain):
            if lvl in self._construct_failed:
                lvl += 1
                continue
            try:
                # dispatch-time faults surface here; realization-time
                # faults (stuck, NaN) in ResilientPending.result()
                pending = self._engine_for(lvl).infer(
                    x, record=record, sync=False)
                break
            except Exception as e:   # noqa: BLE001 — ladder catches all
                self._rung_failed(st, lvl, self._clock(), e)
                lvl += 1
        if pending is None:
            st.down = True
            rp = ResilientPending(self, x, bucket, len(self.chain), None,
                                  record)
            rp._out, rp._done = self._last_resort(x.shape[0]), True
            return rp
        rp = ResilientPending(self, x, bucket, lvl, pending, record)
        self._inflight.append(rp)
        self._gauge_inflight()
        return rp

    def _realize(self, rp: ResilientPending, pending, x, bucket: int,
                 level: int, *, record: bool) -> np.ndarray:
        """Realize an async dispatch; recover down-ladder on failure."""
        st = self._bucket_state(bucket)
        try:
            out = pending.result(timeout_s=self.watchdog_s)
            if not np.isfinite(out).all():
                raise NonFiniteOutput(
                    f"rung {self.chain[level]!r} returned non-finite "
                    "logits")
        except Exception as e:       # noqa: BLE001 — ladder catches all
            self._rung_failed(st, level, self._clock(), e)
            out = self._serve_ladder(x, record=record, start=level + 1)
        else:
            self._rung_served(st, level)
        if rp in self._inflight:
            self._inflight.remove(rp)
            self._gauge_inflight()
        return out

    def run_stream(self, stream, *, warmup: int = 2) -> dict:
        """The double-buffered fixed-size stream loop, ladder-protected: a
        rung that fails to build (or raises mid-stream) demotes and the
        WHOLE stream re-runs on the fallback."""
        stream = list(stream)
        if not stream:
            return self._engines[self._base_level].run_stream(stream,
                                                              warmup=warmup)
        bucket = self.bucket_for(stream[0].shape[0])
        st = self._bucket_state(bucket)
        lvl = self._start_level(st, self._clock())
        last_err: Exception | None = None
        while lvl < len(self.chain):
            if lvl in self._construct_failed:
                lvl += 1
                continue
            try:
                res = self._engine_for(lvl).run_stream(stream, warmup=warmup)
            except Exception as e:   # noqa: BLE001 — ladder catches all
                self._rung_failed(st, lvl, self._clock(), e)
                last_err = e
                lvl += 1
                continue
            self._rung_served(st, lvl)
            return res
        st.down = True
        self.metrics.incr("failed_requests")
        self._last_down = self._clock()
        raise RuntimeError(
            f"every rung of {self.chain} failed for the stream "
            f"(bucket {bucket}); last error: {last_err!r}") from last_err
