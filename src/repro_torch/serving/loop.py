"""Live event-loop front-end: a request queue drained through the fabric.

LL-GNN's whole point is sustained *online* event selection — the L1
trigger drains a continuous stream of events under a hard latency
budget, it does not score pre-cut offline batches.  Until this module
the engine only ever saw offline streams (``run_stream``) or whole
batches (``infer``); this is the missing front-end: a single-threaded
event loop that takes individual requests as they arrive and pushes
them through

    :class:`~repro_torch.serving.batcher.DeadlineBatcher`
        -> ``engine.run_plan(plan, sync=False)``
        -> per-request :class:`RequestFuture`

with the three properties a live front-end owes its operators:

* **bounded in-flight backpressure** — at most ``max_inflight`` plans
  are outstanding on the accelerator; a dispatch past that realizes the
  OLDEST plan first, so a burst cannot pin unbounded device buffers and
  completion latency is what applies the brake.
* **per-request completion futures** — a request may be split across
  several plans (it straddled a bucket cut) and those plans may realize
  out of order; each :class:`RequestFuture` reassembles its parts by
  dispatch sequence and completes exactly when every event it submitted
  has been served or shed.
* **queue-depth / shed accounting** — instantaneous backlog and
  in-flight occupancy land in :meth:`~repro_torch.serving.metrics.
  ServingMetrics.gauge` (``queue_depth``, ``queue_requests``,
  ``inflight_plans``) next to the engine's monotonic shed/demotion
  counters, all in the same ``snapshot()``.

The loop is engine-agnostic: anything with ``bucket_sizes``,
``metrics`` and ``run_plan(plan, sync=False) -> handle`` serves — the
fault-tolerant :class:`~repro_torch.serving.resilient.ResilientEngine`
(whose handles shed expired requests and recover down the degradation
ladder) in production, a bare
:class:`~repro_torch.serving.engine.ServingEngine` in numerics tests.
It is single-threaded and clock-injectable: every transition (flush,
dispatch, backpressure, delivery) happens inside ``submit()`` /
``poll()`` / ``drain()``, so the front-end is deterministic under test.
Port of ``repro.serving.loop``, unchanged in behaviour but for one
gauge: ``inflight_plans`` is also sampled right after each dispatch, so
its ``gauge_max`` is the true peak of plans in flight (the reference
samples it only after a reap, and so can miss the peak a burst reaches).
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.serving.batcher import DeadlineBatcher


class RequestFuture:
    """Completion handle for one submitted request.

    Fills as the loop realizes the plans carrying this request's events;
    ``done`` flips once every event has been served or shed.  ``result()``
    returns the reassembled ``(n, ...)`` outputs — or ``None`` when any
    part was shed past its deadline (a partial answer is no answer for a
    trigger decision; the shed is already counted by the engine).
    """

    def __init__(self, rid: int, n_events: int):
        self.rid = rid
        self.n_events = int(n_events)
        self._parts: list[tuple[int, np.ndarray]] = []   # (dispatch seq, rows)
        self._served = 0
        self._shed = 0
        self._out = None

    @property
    def done(self) -> bool:
        return self._served + self._shed >= self.n_events

    @property
    def shed(self) -> bool:
        """True once any of this request's events were deadline-shed."""
        return self._shed > 0

    def result(self):
        """The request's outputs (``None`` if shed).  The loop must have
        completed it — call ``loop.drain()`` or pump ``loop.poll()`` until
        ``done``; a live front-end never blocks inside a future."""
        if not self.done:
            raise RuntimeError(
                f"request {self.rid} still has events in flight "
                f"({self._served + self._shed}/{self.n_events}); pump "
                "ServingLoop.poll() or call ServingLoop.drain() first")
        if self.shed:
            return None
        if self._out is None:
            # plans realize out of order; dispatch sequence restores the
            # submission order of this request's segments
            parts = [p for _, p in sorted(self._parts, key=lambda t: t[0])]
            self._out = parts[0] if len(parts) == 1 else np.concatenate(
                parts, axis=0)
            self._parts = []
        return self._out

    # -- loop-side delivery -------------------------------------------------

    def _deliver(self, seq: int, rows) -> None:
        self._parts.append((seq, rows))
        self._served += rows.shape[0]

    def _deliver_shed(self, n_events: int) -> None:
        self._shed += n_events


class ServingLoop:
    """Single-threaded event loop: submit -> batch -> dispatch -> deliver."""

    def __init__(self, engine, *, deadline_s: float = 2e-3,
                 max_inflight: int = 4, batcher: DeadlineBatcher | None = None,
                 clock=None):
        self.engine = engine
        # share the resilient engine's clock by default so request
        # deadlines and its shed decisions read the same time base
        self._clock = (clock if clock is not None
                       else getattr(engine, "_clock", time.monotonic))
        self.batcher = (batcher if batcher is not None
                        else DeadlineBatcher(engine.bucket_sizes,
                                             deadline_s=deadline_s,
                                             clock=self._clock))
        self.metrics = engine.metrics
        self.max_inflight = int(max_inflight)
        self._inflight: list[tuple[int, object, object]] = []  # (seq, h, plan)
        self._futures: dict[int, RequestFuture] = {}
        self._next_rid = 0
        self._next_seq = 0

    # -- introspection ------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Events accumulated in the batcher, not yet dispatched."""
        return self.batcher.pending_events

    @property
    def inflight(self) -> int:
        """Plans dispatched to the engine, not yet realized."""
        return len(self._inflight)

    @property
    def idle(self) -> bool:
        return self.queue_depth == 0 and not self._inflight

    # -- request flow -------------------------------------------------------

    def submit(self, x, *, deadline_s: float | None = None) -> RequestFuture:
        """Enqueue one request of ``x.shape[0]`` events; returns its
        future.  A full bucket flushes and dispatches immediately;
        otherwise the events wait for the batcher's deadline fuse
        (serviced by :meth:`poll`).  ``deadline_s`` is the request's
        serve-by budget — once expired, the engine sheds it instead of
        dispatching."""
        x = np.asarray(x)
        rid = self._next_rid
        self._next_rid += 1
        fut = RequestFuture(rid, x.shape[0])
        self._futures[rid] = fut
        self.metrics.incr("loop_requests")
        plans = self.batcher.submit(rid, x, deadline_s=deadline_s)
        # instantaneous backlog INCLUDING what this submission just cut —
        # the high-water mark capacity planning reads (gauge_max)
        self.metrics.gauge("queue_depth", self.batcher.pending_events
                           + sum(p.n_valid for p in plans))
        self._dispatch(plans)
        self._reap()
        self._update_gauges()
        return fut

    def poll(self) -> None:
        """One event-loop tick: fire the batcher's deadline fuse, dispatch
        what it flushed, deliver any plans that finished."""
        self._dispatch(self.batcher.poll())
        self._reap()
        self._update_gauges()

    def drain(self) -> None:
        """End of stream / shutdown: force-flush the batcher and realize
        every in-flight plan; afterwards every issued future is done."""
        self._dispatch(self.batcher.flush())
        while self._inflight:
            self._realize(self._inflight[0])
        self._update_gauges()

    # -- internals ----------------------------------------------------------

    def _dispatch(self, plans) -> None:
        for plan in plans:
            while len(self._inflight) >= self.max_inflight:
                # backpressure: the oldest plan's completion is the brake
                self._realize(self._inflight[0])
            handle = self.engine.run_plan(plan, sync=False)
            self._inflight.append((self._next_seq, handle, plan))
            self._next_seq += 1
            self.metrics.incr("loop_plans")
            # sampled at its high-water mark, before any reap can lower it
            self.metrics.gauge("inflight_plans", len(self._inflight))

    def _reap(self) -> None:
        """Deliver every in-flight plan that is already realized-ready —
        non-blocking, so a fast small plan completes its futures even
        while an older big one still computes (out-of-order delivery)."""
        for entry in [e for e in self._inflight if e[1].ready]:
            self._realize(entry)

    def _realize(self, entry) -> None:
        seq, handle, plan = entry
        self._inflight.remove(entry)
        results = handle.result()
        rows = {}
        for rid, start, stop in plan.requests:
            rows[rid] = rows.get(rid, 0) + (stop - start)
        for rid, out in results.items():
            fut = self._futures.get(rid)
            if fut is None:
                continue
            if out is None:                       # engine shed this segment
                fut._deliver_shed(rows[rid])
            else:
                fut._deliver(seq, out)
            if fut.done:
                self.metrics.incr("loop_completed")
                # the caller holds the future; the loop can forget it
                del self._futures[rid]

    def _update_gauges(self) -> None:
        self.metrics.gauge("queue_depth", self.batcher.pending_events)
        self.metrics.gauge("queue_requests", self.batcher.pending_requests)
        self.metrics.gauge("inflight_plans", len(self._inflight))
