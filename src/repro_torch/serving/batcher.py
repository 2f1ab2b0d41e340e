"""Deadline-aware micro-batcher: requests -> pad-to-bucket batch plans.

The trigger tier receives many small requests (an event, a handful of
events) and must answer each within a latency budget.  Dispatching every
request alone wastes the accelerator; waiting for a full batch blows the
budget on quiet links.  The batcher resolves the tension the way every
production serving stack does — accumulate, flush on whichever comes
first:

* **full bucket** — pending events reach the largest compile bucket;
* **deadline** — the OLDEST pending request has waited ``deadline_s``.

Port of ``repro.serving.batcher``, unchanged in behaviour.  Bucket
sizes come from the serving engine's ladder (each kernel's own
``Layout``, :mod:`repro_torch.kernels.autotune`), so a deadline flush
pads to the nearest ladder rung and hits a bucket whose bound callable
is already cached.

The batcher is pure planning — numpy only, no torch, no clocks of its
own (``clock`` is injectable for deterministic tests).  The engine
executes the plans.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """One flushed batch: concatenated valid events + reassembly map."""

    x: np.ndarray                       # (n_valid, N_o, P) — engine pads
    bucket: int                         # ladder rung to pad/compile to
    requests: tuple                     # ((rid, start, stop), ...) into x
    oldest_wait_s: float                # age of the oldest request at flush
    reason: str                         # "full" | "deadline" | "forced"
    #: Absolute per-request deadlines (batcher clock), aligned 1:1 with
    #: ``requests``; ``None`` where the request declared none.  The
    #: resilient engine sheds segments already past their deadline
    #: instead of dispatching them.
    deadlines: tuple = ()

    @property
    def n_valid(self) -> int:
        return int(self.x.shape[0])

    def deadline_for(self, i: int) -> float | None:
        """Deadline of ``requests[i]`` (None for legacy 5-field plans)."""
        return self.deadlines[i] if i < len(self.deadlines) else None


@dataclasses.dataclass
class _Pending:
    rid: int
    x: np.ndarray
    t_submit: float
    t_deadline: float | None = None     # absolute serve-by time, if any


class DeadlineBatcher:
    """Accumulate requests into bucket-sized batches under a deadline."""

    def __init__(self, bucket_sizes, *, deadline_s: float = 2e-3,
                 clock=time.monotonic):
        if not bucket_sizes:
            raise ValueError("need at least one bucket size")
        self.bucket_sizes = sorted(int(b) for b in bucket_sizes)
        self.deadline_s = float(deadline_s)
        self._clock = clock
        self._pending: list[_Pending] = []

    # -- introspection ------------------------------------------------------

    @property
    def pending_events(self) -> int:
        return sum(p.x.shape[0] for p in self._pending)

    @property
    def pending_requests(self) -> int:
        return len(self._pending)

    def bucket_for(self, n_events: int) -> int:
        """Smallest ladder rung holding ``n_events`` (largest if none do)."""
        from repro_torch.kernels.autotune import bucket_for
        return bucket_for(self.bucket_sizes, n_events)

    # -- request flow -------------------------------------------------------

    def submit(self, rid: int, x: np.ndarray, *, now: float | None = None,
               deadline_s: float | None = None) -> list[BatchPlan]:
        """Enqueue one request of ``x.shape[0]`` events.

        Returns the batch plans this submission made ready (full-bucket
        flushes); empty list while the batch is still filling.

        ``deadline_s`` is the request's serve-by budget relative to
        ``now``; it rides through the flushed plan (absolute time, same
        clock) so the engine can shed it once expired instead of
        spending accelerator time on an answer nobody is waiting for.
        """
        if x.ndim < 1 or x.shape[0] == 0:
            raise ValueError("request must carry at least one event")
        now = self._clock() if now is None else now
        t_deadline = None if deadline_s is None else now + deadline_s
        self._pending.append(_Pending(rid=rid, x=np.asarray(x), t_submit=now,
                                      t_deadline=t_deadline))
        plans = []
        while self.pending_events >= self.bucket_sizes[-1]:
            plans.append(self._cut(self.bucket_sizes[-1], now, "full"))
        return plans

    def poll(self, *, now: float | None = None) -> list[BatchPlan]:
        """Deadline check: flush everything pending once the oldest request
        has waited ``deadline_s`` (the whole backlog goes — leaving younger
        events behind would just re-arm an already-burning fuse)."""
        if not self._pending:
            return []
        now = self._clock() if now is None else now
        if now - self._pending[0].t_submit < self.deadline_s:
            return []
        return self._drain(now, "deadline")

    def flush(self, *, now: float | None = None) -> list[BatchPlan]:
        """Force out everything pending (shutdown / end of stream)."""
        now = self._clock() if now is None else now
        return self._drain(now, "forced")

    # -- internals ----------------------------------------------------------

    def _drain(self, now: float, reason: str) -> list[BatchPlan]:
        plans = []
        while self.pending_events > self.bucket_sizes[-1]:
            plans.append(self._cut(self.bucket_sizes[-1], now, reason))
        if self._pending:
            plans.append(self._cut(self.pending_events, now, reason))
        return plans

    def _cut(self, n_events: int, now: float, reason: str) -> BatchPlan:
        """Pop up to ``n_events`` events off the queue head into one plan.

        Requests are split across plans when they straddle the cut — each
        (rid, start, stop) segment maps output rows back to its request.
        """
        parts, segments, deadlines = [], [], []
        taken = 0
        oldest = now - self._pending[0].t_submit
        while self._pending and taken < n_events:
            head = self._pending[0]
            room = n_events - taken
            if head.x.shape[0] <= room:
                self._pending.pop(0)
                part = head.x
            else:
                part = head.x[:room]
                head.x = head.x[room:]
            parts.append(part)
            segments.append((head.rid, taken, taken + part.shape[0]))
            deadlines.append(head.t_deadline)
            taken += part.shape[0]
        return BatchPlan(
            x=np.concatenate(parts, axis=0),
            bucket=self.bucket_for(taken),
            requests=tuple(segments),
            oldest_wait_s=oldest,
            reason=reason,
            deadlines=tuple(deadlines),
        )
