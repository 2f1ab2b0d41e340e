"""A chunk's logits on their way back to the host (``serving/core.py``:
``DeviceResult``, ``StagingRing.send``, ``PendingResult``).

On a card, ``ExecutionCore.infer`` enqueues each output's copy into a
reused pinned slot of its output ring right behind the launch, records
the result's event after that copy, and realizes by copying the rows out
of the slot.  Here the card is stood in for by a tensor that says it is
on one (``OnCard``), unpinned slots and fake events whose ``query()``
and ``synchronize()`` a test controls: each result gets its own logits
in any order of realization, a slot is never given to a new launch
before its rows are out, a timed-out result's slot is never reused, the
watchdog starts no thread, and each realize of a card's result counts
one ``core.d2h_early``.  The card's own test is
``tests/test_torch_cuda.py::test_async_results_equal_the_synchronous_copy``.
"""

import collections
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.serving import FaultInjector, ServingMetrics
from repro_torch.serving.core import (
    D2H_COUNTERS,
    DeviceResult,
    ExecutionCore,
    PendingResult,
    StagingRing,
    WatchdogTimeout,
    Workload,
)

ROW = (3,)


class OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` as a card's output would."""

    @property
    def is_cuda(self):
        return True


class FakeEvent:
    """A copy that lands only when a test says so (or is waited on)."""

    def __init__(self):
        self.done = True
        self.waits = 0
        self.polls = 0
        self.streams = []

    def record(self, stream=None):
        self.done = False
        self.streams.append(stream)

    def query(self):
        self.polls += 1
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True


class Doubler(Workload):
    name = "doubler"

    def bucket_ladder(self, max_batch):
        return [4, 8]

    def build(self, bucket):
        return lambda x: (x * 2).as_subclass(OnCard)

    def placeholder(self, bucket):
        return np.zeros((bucket, *ROW), np.float32)


class OnHost(Doubler):
    def build(self, bucket):
        return lambda x: x * 2


@pytest.fixture
def card(monkeypatch):
    """A core whose outputs come back through a fake output ring, as on
    CUDA; returns a factory ``(limit=8) -> core``."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: "compute")
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)

    def make(limit=8):
        core = ExecutionCore(Doubler(), max_batch=8)
        core._outputs = StagingRing(limit=limit, pin=False,
                                    new_event=FakeEvent, counter="core.d2h_")
        return core
    return make


def _x(n, value):
    return (np.arange(n * ROW[0], dtype=np.float32).reshape(n, *ROW)
            + value)


def _counts(m):
    return {k: m.counter(k) for k in D2H_COUNTERS if m.counter(k)}


def _claims(p):
    return [c[0]._claim for c in p._chunks]


def test_results_realized_out_of_order_each_return_their_own(card):
    core = card()
    xs = [_x(5 + i % 3, 100 * i) for i in range(6)]
    pend = [core.infer(x, sync=False) for x in xs]
    assert not any(p.ready for p in pend)          # copies not landed
    for i in (3, 0, 5, 1, 4, 2):
        np.testing.assert_array_equal(pend[i].result(), 2 * xs[i])
    assert _counts(core.metrics) == {"core.d2h_grown": 6,
                                     "core.d2h_early": 6}
    # every slot is free again: the next six launches reuse them
    for x in xs:
        core.infer(x)
    assert core.metrics.counter("core.d2h_reused") == 6


def test_realized_rows_are_an_array_of_their_own(card):
    core = card()
    p = core.infer(_x(8, 1), sync=False)
    claim, = _claims(p)
    out = p.result()
    assert claim.rows is not None
    assert not np.shares_memory(out, claim.slot.array)
    assert not np.shares_memory(claim.rows, claim.slot.array)


def test_a_slot_is_never_given_to_a_launch_before_its_rows_are_out(card):
    """The ring grows while the oldest slot's rows are in it; at its limit
    it waits on the oldest copy and moves those rows out first."""
    core = card(limit=2)
    a = core.infer(_x(8, 1), sync=False)
    b = core.infer(_x(8, 2), sync=False)
    (ca,), (cb,) = _claims(a), _claims(b)
    assert ca.slot is not cb.slot
    assert _counts(core.metrics) == {"core.d2h_grown": 2}
    c = core.infer(_x(8, 3), sync=False)        # full: waits on a's copy
    (cc,) = _claims(c)
    assert cc.slot is ca.slot and ca.copied.waits == 1
    assert cb.copied.waits == 0 and ca.rows is not None
    assert core.metrics.counter("core.d2h_waited") == 1
    for p, v in ((c, 3), (a, 1), (b, 2)):
        np.testing.assert_array_equal(p.result(), 2 * _x(8, v))
    # a's slot (now c's) and b's are free: reused without a wait
    d = core.infer(_x(8, 4), sync=False)
    assert _claims(d)[0].slot is cb.slot
    assert core.metrics.counter("core.d2h_reused") == 1


def test_a_request_past_the_limit_pipelines_through_the_ring(card):
    core = card(limit=1)
    x = _x(20, 7)                      # chunks of 8, 8, 4
    np.testing.assert_array_equal(core.infer(x), 2 * x)
    assert _counts(core.metrics) == {"core.d2h_grown": 2,
                                     "core.d2h_waited": 1,
                                     "core.d2h_early": 3}


def test_a_timed_out_result_s_slot_is_never_reused(card):
    core = card(limit=1)
    late = core.infer(_x(8, 1), sync=False)
    claim, = _claims(late)
    with pytest.raises(WatchdogTimeout):
        late.result(timeout_s=0.01)
    assert claim.rows is None
    slots = set()
    for i in range(5):
        p = core.infer(_x(8, 10 + i), sync=False)
        slots.add(id(_claims(p)[0].slot))
        claim.slot.array[:] = -1.0             # the lost copy lands late
        np.testing.assert_array_equal(p.result(), 2 * _x(8, 10 + i))
    assert id(claim.slot) not in slots and len(slots) == 1


def test_dropping_a_drained_claim_leaves_the_slot_s_new_owner_alone(card):
    core = card(limit=1)
    ring = core._outputs
    a = core.infer(_x(8, 1), sync=False)
    (ca,) = _claims(a)
    b = core.infer(_x(8, 2), sync=False)        # waits: a's rows move out
    (cb,) = _claims(b)
    assert cb.slot is ca.slot
    ring.drop(ca)
    np.testing.assert_array_equal(b.result(), 2 * _x(8, 2))
    c = core.infer(_x(8, 3), sync=False)
    assert _claims(c)[0].slot is cb.slot
    np.testing.assert_array_equal(a.result(), 2 * _x(8, 1))


def test_every_chunk_after_a_timed_out_one_is_abandoned(card):
    core = card()
    p = core.infer(_x(20, 1), sync=False)       # chunks 8, 8, 4
    claims = _claims(p)
    with pytest.raises(WatchdogTimeout):
        p.result(timeout_s=0.0)
    ring = core._outputs
    assert not any(c.slot in ring._ring[c.slot.key] for c in claims)


class _Counting(threading.Thread):
    started = 0

    def start(self):
        type(self).started += 1
        super().start()


def test_watchdog_wait_polls_on_the_calling_thread(card, monkeypatch):
    """A result not ready under a deadline is polled, never handed to a
    thread, and returns once its copy lands."""
    monkeypatch.setattr(threading, "Thread", _Counting)
    core = card()
    p = core.infer(_x(8, 1), sync=False)
    claim, = _claims(p)
    polls = [0]
    query = claim.copied.query

    def lands_on_the_fifth_poll():
        polls[0] += 1
        if polls[0] == 5:
            claim.copied.done = True
        return query()
    claim.copied.query = lands_on_the_fifth_poll
    np.testing.assert_array_equal(p.result(timeout_s=5.0), 2 * _x(8, 1))
    assert polls[0] == 5 and _Counting.started == 0


def test_stuck_seam_raises_at_the_deadline_without_a_thread(monkeypatch):
    monkeypatch.setattr(threading, "Thread", _Counting)
    inj = FaultInjector()
    inj.arm("stuck", times=1, delay_s=5.0)
    core = ExecutionCore(OnHost(), max_batch=8, injector=inj)
    p = core.infer(_x(8, 1), sync=False)
    t0 = time.perf_counter()
    with pytest.raises(WatchdogTimeout):
        p.result(timeout_s=0.05)
    assert 0.05 <= time.perf_counter() - t0 < 1.0
    assert inj.fired("stuck") == 1 and _Counting.started == 0
    np.testing.assert_array_equal(core.infer(_x(8, 2), timeout_s=1.0),
                                  2 * _x(8, 2))


def test_stuck_seam_abandons_the_wrapped_result_s_slot(card):
    core = card()
    core.injector = inj = FaultInjector()
    inj.arm("stuck", times=1, delay_s=5.0)
    p = core.infer(_x(8, 1), sync=False)
    stuck = p._chunks[0][0]
    claim = stuck._inner._claim
    assert stuck.d2h == "early"
    with pytest.raises(WatchdogTimeout):
        p.result(timeout_s=0.01)
    assert claim.slot not in core._outputs._ring[claim.slot.key]


def test_a_cpu_core_keeps_today_s_path():
    core = ExecutionCore(OnHost(), max_batch=8)
    assert core._outputs is None
    r = DeviceResult(torch.ones(2, 3))
    assert r.d2h is None and r.is_ready()
    x = _x(11, 3)
    np.testing.assert_array_equal(core.infer(x), 2 * x)
    assert _counts(core.metrics) == {}


def test_each_realize_counts_exactly_one_way_back(card):
    core = card()
    m = core.metrics
    ring = core._outputs
    t = torch.ones(8, *ROW).as_subclass(OnCard)
    chunks = [(DeviceResult(t, ring, m.incr), 8, 8, 0.0),
              (DeviceResult(torch.ones(8, *ROW)), 8, 8, 0.0),  # on the host
              (np.ones((8, *ROW), np.float32), 8, 8, 0.0)]   # output_nan
    PendingResult(core, chunks, record=False).result()
    assert m.counter("core.d2h_early") == 1
    p = core.infer(_x(20, 0), sync=False)
    p.result()
    p.result()                                   # realized once
    assert m.counter("core.d2h_early") == 1 + 3


def test_warm_leaves_each_bucket_s_output_slot_allocated(card):
    core = card()
    core.warm()
    assert _counts(core.metrics) == {"core.d2h_grown": 2}
    for n in (3, 8):
        core.infer(_x(n, 1))
    assert core.metrics.counter("core.d2h_grown") == 2
    assert core.metrics.counter("core.d2h_reused") == 2


def test_threads_sending_at_once_each_get_their_own_rows():
    """More threads than cores on one ring, a short switch interval, copies
    landing in any order: each thread reads back exactly what it sent and
    no slot is out to two claims at once."""
    ring = StagingRing(limit=3, pin=False, new_event=FakeEvent,
                       counter="core.d2h_")
    m = ServingMetrics()
    errors = []
    n_threads, rounds = 12, 150

    def work(tid):
        held = collections.deque()
        for r in range(rounds):
            t = torch.full((8, *ROW), float(tid * 1000 + r))
            held.append((r, ring.send(t, f"s{tid}", m.incr)))
            if len(held) > (tid % 3) + 1:
                r0, claim = held.popleft()
                claim.copied.done = (tid + r) % 2 == 0
                rows = claim.synchronize()
                if not (rows == tid * 1000 + r0).all():
                    errors.append((tid, r0))
        while held:
            r0, claim = held.popleft()
            if not (claim.synchronize() == tid * 1000 + r0).all():
                errors.append((tid, r0))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert sum(m.counter("core.d2h_" + k)
               for k in ("reused", "grown", "waited")) == n_threads * rounds
