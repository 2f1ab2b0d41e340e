"""Online silent-corruption sentinel: canaries, shadows, quarantine.

Port of ``repro.serving.sentinel``, with the reference's rules as they
are.  The degradation ladder (:mod:`repro_torch.serving.resilient`)
catches loud failures — exceptions, NaN logits, watchdog timeouts.  It
is blind to *finite wrong answers*: a drifted int8 ``w_scale``, a
corrupted weight tensor, or a stale cache entry (the silent seams of
:mod:`repro_torch.serving.faults`) produce logits that are shaped,
finite and wrong while ``health()`` reads ``healthy``.  The sentinel
closes that gap with three mechanisms:

**Golden canaries.**  At construction the sentinel draws one small
fixed canary batch (``RandomState(seed ^ 0xC0FFEE)``, drawn exactly as
the reference draws it) and precomputes *golden* logits per
constructible chain rung from the rung spec's own ``ref`` on the
engine's device.  On a per-bucket request-count (and optional time)
cadence — and on the FIRST request a bucket ever serves — the canary is
injected through the live rung pinned to the bucket's cached callable
(``infer(bucket=...)``), so a 4-event probe pads to the bucket and runs
the same kernel launch and packed weights live traffic does.  It is
compared against the golden within ``tolerance_slack x
PathSpec.tolerance``, an absolute bar.

**Shadow re-execution.**  A duty-cycled sample of live requests
(stride ``round(1/shadow_rate)``, never a random draw) re-runs on the
chain's terminal rung (:func:`repro_torch.core.paths.terminal_rung`),
plain PyTorch.  Per-bucket EWMA max-|Δlogit| and argmax disagreement
land in metrics gauges.  The trip threshold is calibrated from the
golden table (``slack x max(|golden[rung] - golden[terminal]|,
tolerance)``), so an int8 rung's quantization gap never trips it.
Asynchronous shadows run on a worker thread; on the card that thread
runs every job inside its own ``torch.cuda.Stream``, so the shadow's
copy, its matmuls and its ready event never queue behind live kernels
on the serve thread's stream.  The terminal rung launches no
hand-written kernel, so the worker never touches a kernel wrapper's
``launches`` counter.  The worker only *records* trips; the serve
thread applies them at its next ``observe()``.

**Canary-gated quarantine.**  A trip evicts the rung's cached callable
for that bucket (with the packed weights it holds, so build-time
corruption is rebuilt from the source params), demotes the bucket below
the rung and marks it ``quarantined``; it re-promotes only after
``promote_after`` CONSECUTIVE clean canaries at the quarantined rung.

The sentinel reads time only through the engine's injectable clock.
TF32 is left as the caller set it (off by default): the shadow's fp32
matmuls must stay fp32 or they drift ~1e-3 from an fp32 kernel rung.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch.core import paths as forward_paths
from repro_torch.serving.engine import params_to


@dataclasses.dataclass
class SentinelConfig:
    """Knobs for one :class:`Sentinel`.

    ``canary_every`` is a per-bucket request-count cadence (the first
    request a bucket serves always canaries); ``canary_interval_s``
    optionally adds a time cadence on the engine's clock.
    ``shadow_rate`` is the duty cycle of terminal-rung shadow
    re-execution (0 disables it); ``shadow_sync`` runs shadow jobs
    inline on the serve thread.  ``promote_after`` is the clean canary
    streak a quarantined rung needs to re-promote.  ``tolerance_slack``
    scales ``PathSpec.tolerance`` into the canary trip threshold.
    """

    canary_every: int = 64
    canary_interval_s: float | None = None
    shadow_rate: float = 1 / 16
    shadow_sync: bool = False
    shadow_queue: int = 64
    promote_after: int = 3
    tolerance_slack: float = 8.0
    canary_events: int = 4
    ewma_alpha: float = 0.5
    seed: int = 0


class Sentinel:
    """Online correctness monitor bound to one ResilientEngine."""

    def __init__(self, engine, config: SentinelConfig | None = None, *,
                 clock=None):
        self.config = config if config is not None else SentinelConfig()
        self._engine = engine
        self._clock = clock if clock is not None else engine._clock
        cfg = engine.cfg
        # decorrelate the canary draw from common user seeds: live
        # traffic drawn from RandomState(0) must never alias the canary
        # batch, or a stale entry replaying that traffic would pass by
        # construction
        rng = np.random.RandomState((self.config.seed ^ 0xC0FFEE) & 0xFFFFFFFF)
        self._canary_x = rng.normal(
            0.0, 1.0, (self.config.canary_events, cfg.n_objects,
                       cfg.n_features)).astype(np.float32)
        self.terminal_level = len(engine.chain) - 1
        self.device = engine.device

        # golden logits per constructible rung, from the rung's own ref
        # on ITS prepared params (int8 rungs against the int8 oracle)
        self._golden: dict[int, np.ndarray] = {}
        params = params_to(engine._params, self.device)
        x = torch.from_numpy(self._canary_x).to(self.device)
        for lvl, name in enumerate(engine.chain):
            if lvl in engine._construct_failed:
                continue
            spec = forward_paths.get(name)
            try:
                g = spec.ref(spec.prepare_params(params), cfg, x)
                self._golden[lvl] = g.float().cpu().numpy()
            except Exception:   # noqa: BLE001 — a rung without a golden
                pass            # just cannot canary (counted per canary)

        # shadow trip threshold per rung: the rung's OWN legitimate gap
        # to the terminal oracle (e.g. int8 quantization loss), slacked
        golden_t = self._golden.get(self.terminal_level)
        self._shadow_thr: dict[int, float] = {}
        for lvl, g in self._golden.items():
            base = (float(np.abs(g - golden_t).max())
                    if golden_t is not None else 0.0)
            tol = forward_paths.get(engine.chain[lvl]).tolerance
            self._shadow_thr[lvl] = (
                self.config.tolerance_slack * max(base, tol))

        self._since: dict[int, int] = {}       # requests since last canary
        self._last_canary: dict[int, float] = {}
        self._shadow_count = 0
        self._ewma: dict[int, tuple[float, float]] = {}  # bucket -> (dev, arg)
        self._stats_lock = threading.Lock()
        self._pending: list[tuple[int, int]] = []        # (bucket, level)
        self._pending_lock = threading.Lock()
        self._queue: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        #: the shadow worker's own CUDA stream (None off the card or
        #: before the first asynchronous shadow)
        self.shadow_stream: torch.cuda.Stream | None = None

    # -- serve-thread surface ------------------------------------------------

    def observe(self, x, out, bucket: int, level: int) -> None:
        """One recorded live serve happened on ``bucket`` at ``level``:
        apply any shadow-worker trips, duty-cycle the request into a
        shadow, and run the canary when the bucket's cadence is due."""
        self._apply_pending()
        if self._should_shadow(bucket, level):
            self._submit_shadow(np.asarray(x), np.asarray(out), bucket,
                                level)
        cnt = self._since.get(bucket, self.config.canary_every)
        due = cnt >= self.config.canary_every
        if not due and self.config.canary_interval_s is not None:
            last = self._last_canary.get(bucket)
            due = (last is None
                   or self._clock() - last >= self.config.canary_interval_s)
        if due:
            self.canary(bucket)
        else:
            self._since[bucket] = cnt + 1

    def canary(self, bucket: int) -> bool | None:
        """Inject the golden canary through ``bucket``'s live rung.

        Quarantined buckets canary their QUARANTINED rung (the
        requalification gate); healthy buckets canary the active rung.
        Returns True (clean), False (mismatch -> quarantine), or None
        (no golden / rung raised — loud failures are the ladder's job).
        """
        eng = self._engine
        st = eng._bucket_state(bucket)
        lvl = st.q_level if st.quarantined else st.level
        m = eng.metrics
        m.incr("canaries")
        self._since[bucket] = 0
        self._last_canary[bucket] = self._clock()
        golden = self._golden.get(lvl)
        if golden is None:
            m.incr("canary_errors")
            return None
        n = min(self._canary_x.shape[0], bucket)
        try:
            # no watchdog thread: the canary rides a rung that just
            # served a live request (wedges trip the loud ladder there)
            live = eng._engine_for(lvl).infer(
                self._canary_x[:n], record=False, bucket=bucket)
        except Exception:   # noqa: BLE001 — loud canary failure: not a
            m.incr("canary_errors")   # silent trip, but never a clean pass
            if st.quarantined:
                st.clean = 0
            return None
        dev = float(np.abs(np.asarray(live, np.float32) - golden[:n]).max())
        m.gauge(f"canary_dev_b{bucket}", dev)
        tol = forward_paths.get(eng.chain[lvl]).tolerance
        if np.isfinite(dev) and dev <= self.config.tolerance_slack * tol:
            if st.quarantined:
                st.clean += 1
                if st.clean >= self.config.promote_after:
                    eng._requalify(bucket)
            return True
        m.incr("canary_mismatches")
        eng._quarantine(bucket, lvl)
        return False

    def detail(self) -> dict:
        """Sentinel block for ``health()``."""
        with self._stats_lock:
            ewma = {b: {"dev": d, "argmax_disagree": a}
                    for b, (d, a) in sorted(self._ewma.items())}
        return {
            "canary_every": self.config.canary_every,
            "shadow_rate": self.config.shadow_rate,
            "promote_after": self.config.promote_after,
            "golden_rungs": sorted(self._golden),
            "shadow_ewma": ewma,
        }

    # -- shadow re-execution -------------------------------------------------

    def _should_shadow(self, bucket: int, level: int) -> bool:
        if self.config.shadow_rate <= 0 or level >= self.terminal_level:
            return False
        st = self._engine._state.get(bucket)
        if st is not None and st.quarantined:
            return False        # already caught; canaries gate recovery
        stride = max(1, int(round(1.0 / self.config.shadow_rate)))
        self._shadow_count += 1
        return self._shadow_count % stride == 0

    def _submit_shadow(self, x, out, bucket: int, level: int) -> None:
        if self.config.shadow_sync:
            self._shadow_job(x, out, bucket, level)
            return
        if self._worker is None:
            # build the terminal rung here, on the serve thread, so its
            # weights are resident before the worker's stream reads them
            try:
                self._engine._engine_for(self.terminal_level)
            except Exception:   # noqa: BLE001 — counted as shadow_errors
                pass            # by each job that then finds no oracle
            if self.device.type == "cuda":
                self.shadow_stream = torch.cuda.Stream(self.device)
                self.shadow_stream.wait_stream(
                    torch.cuda.current_stream(self.device))
            self._queue = queue.Queue(maxsize=self.config.shadow_queue)
            self._worker = threading.Thread(
                target=self._worker_loop, name="sentinel-shadow",
                daemon=True)
            self._worker.start()
        try:
            self._queue.put_nowait((np.array(x, copy=True),
                                    np.array(out, copy=True),
                                    bucket, level))
        except queue.Full:
            self._engine.metrics.incr("shadow_dropped")

    def _worker_loop(self) -> None:
        ctx = (torch.cuda.stream(self.shadow_stream)
               if self.shadow_stream is not None else contextlib.nullcontext())
        with ctx:
            while True:
                item = self._queue.get()
                try:
                    if item is None:
                        return
                    self._shadow_job(*item)
                finally:
                    self._queue.task_done()

    def _shadow_job(self, x, out, bucket: int, level: int) -> None:
        """Re-run ``x`` on the terminal rung; fold agreement stats into
        metrics; RECORD (never apply) a trip on disagreement beyond the
        rung's calibrated threshold."""
        m = self._engine.metrics
        m.incr("shadow_requests")
        try:
            ref = self._engine._engine_for(self.terminal_level).infer(
                x, record=False)
        except Exception:   # noqa: BLE001 — oracle unavailable: no verdict
            m.incr("shadow_errors")
            return
        ref = np.asarray(ref, np.float32)
        out = np.asarray(out, np.float32)
        dev = float(np.abs(out - ref).max())
        disagree = float(np.mean(np.argmax(out, axis=-1)
                                 != np.argmax(ref, axis=-1)))
        a = self.config.ewma_alpha
        with self._stats_lock:
            prev = self._ewma.get(bucket)
            ewma = ((dev, disagree) if prev is None else
                    (a * dev + (1 - a) * prev[0],
                     a * disagree + (1 - a) * prev[1]))
            self._ewma[bucket] = ewma
        m.gauge(f"shadow_dev_ewma_b{bucket}", ewma[0])
        m.gauge(f"shadow_argmax_ewma_b{bucket}", ewma[1])
        thr = self._shadow_thr.get(level)
        if thr is not None and (not np.isfinite(dev) or dev > thr):
            m.incr("shadow_disagreements")
            with self._pending_lock:
                self._pending.append((bucket, level))

    def _apply_pending(self) -> None:
        """Serve-thread application of shadow-worker trips."""
        with self._pending_lock:
            trips, self._pending = self._pending, []
        for bucket, level in trips:
            st = self._engine._bucket_state(bucket)
            if st.quarantined and st.q_level == level:
                continue        # already quarantined on this rung
            self._engine._quarantine(bucket, level)

    def drain(self) -> None:
        """Block until every queued shadow job has run, then apply any
        trips they recorded (tests and orderly shutdown)."""
        if self._queue is not None:
            self._queue.join()
        self._apply_pending()

    def close(self) -> None:
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=5.0)
            self._worker = None
            self._queue = None
