"""The engine's staging ring (``serving/core.py``, ``StagingRing``).

On the CPU the ring runs over unpinned slots and fake events, whose
``query()`` and ``synchronize()`` a test controls: a slot whose copy to
the card is still pending is never refilled, a refilled slot equals
``Workload.pad`` byte for byte, each fill is counted, and threads never
share a slot.  On a card (marker ``cuda``, skips without one):
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_staging.py`` holds ``infer(sync=False)`` with four
batches in flight against ``sync=True`` on a fresh core.
"""

import collections
import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from repro_torch.serving import ServingMetrics
from repro_torch.serving.core import (
    MAX_STAGING_SLOTS,
    ExecutionCore,
    StagingRing,
    Workload,
)

ROW = (2, 3)


class FakeEvent:
    """An event that completes only when a test says so (or is waited on)."""

    def __init__(self):
        self.done = True
        self.waits = 0
        self.streams = []

    def record(self, stream=None):
        self.done = False
        self.streams.append(stream)

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True


def _ring(limit=MAX_STAGING_SLOTS):
    m = ServingMetrics()
    return StagingRing(limit=limit, pin=False, new_event=FakeEvent), m


def _chunk(n, value=1.0, dtype=np.float32):
    base = np.arange(n * 6, dtype=np.float64).reshape(n, *ROW)
    return (base + value).astype(dtype)


def _counts(m):
    return tuple(m.counter("core.stage_" + k)
                 for k in ("reused", "grown", "waited"))


def test_pending_slot_is_never_refilled_ring_grows_then_waits():
    ring, m = _ring(limit=3)
    held = []
    for i in range(3):
        slot = ring.fill(_chunk(5, 10 * i), 8, m.incr)
        assert all(slot is not s for s in held)
        ring.release(slot, stream=f"s{i}")
        held.append(slot)
    assert _counts(m) == (0, 3, 0)
    assert [s.event.waits for s in held] == [0, 0, 0]

    # at the limit with every copy pending: wait on the oldest, reuse it
    slot = ring.fill(_chunk(5, 99), 8, m.incr)
    assert slot is held[0] and slot.event.waits == 1
    assert held[1].event.waits == held[2].event.waits == 0
    assert _counts(m) == (0, 3, 1)
    ring.release(slot)

    # the oldest (now held[1]) done: reused without a wait, no growth
    held[1].event.done = True
    slot = ring.fill(_chunk(5, 7), 8, m.incr)
    assert slot is held[1] and slot.event.waits == 0
    assert _counts(m) == (1, 3, 1)                # no slot added
    assert held[0].event.streams == ["s0", None]


def test_ring_grows_while_the_oldest_copy_is_pending():
    ring, m = _ring()
    first = ring.fill(_chunk(4), 8, m.incr)
    ring.release(first)
    second = ring.fill(_chunk(4, 2), 8, m.incr)
    assert second is not first
    np.testing.assert_array_equal(first.array[:4], _chunk(4))
    assert _counts(m) == (0, 2, 0)


@pytest.mark.parametrize("sizes", [(7, 3), (3, 7), (8, 1, 8), (5, 5),
                                   (8, 2, 6, 1)])
def test_refilled_slot_equals_the_pad(sizes):
    ring, m = _ring(limit=1)
    for k, n in enumerate(sizes):
        chunk = _chunk(n, 100 * k + 1)
        slot = ring.fill(chunk, 8, m.incr)
        want = Workload().pad(chunk, 8)
        assert slot.array.tobytes() == want.tobytes()
        assert not slot.array[n:].any()
        assert slot.rows == n
        ring.release(slot)
        slot.event.done = True
    assert _counts(m) == (len(sizes) - 1, 1, 0)


def test_slot_is_keyed_by_bucket_row_shape_and_dtype():
    ring, m = _ring()
    a = ring.fill(_chunk(3), 8, m.incr)
    ring.release(a)
    a.event.done = True
    b = ring.fill(_chunk(3, dtype=np.float64), 8, m.incr)
    c = ring.fill(_chunk(3), 4, m.incr)
    d = ring.fill(np.zeros((3, 5), np.float32), 8, m.incr)
    assert len({id(s) for s in (a, b, c, d)}) == 4
    assert (b.array.dtype, c.array.shape, d.array.shape) == (
        np.float64, (4, *ROW), (8, 5))
    assert _counts(m) == (0, 4, 0)


@pytest.mark.parametrize("case,want", [("reused", (1, 1, 0)),
                                       ("grown", (0, 2, 0)),
                                       ("waited", (0, 1, 1))])
def test_each_fill_counts_one_case(case, want):
    ring, m = _ring(limit=1 if case == "waited" else 2)
    slot = ring.fill(_chunk(2), 4, m.incr)
    ring.release(slot)
    slot.event.done = case == "reused"
    again = ring.fill(_chunk(2, 5), 4, m.incr)
    assert (again is slot) == (case != "grown")
    assert _counts(m) == want


def test_two_threads_staging_at_once_never_share_a_slot():
    ring, m = _ring()
    barrier = threading.Barrier(2, timeout=10)
    got = [None, None]

    def stage(i):
        barrier.wait()
        got[i] = ring.fill(_chunk(3, i), 8, m.incr)

    threads = [threading.Thread(target=stage, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert got[0] is not None and got[1] is not None
    assert got[0] is not got[1]
    for i in range(2):
        np.testing.assert_array_equal(got[i].array[:3], _chunk(3, i))


def test_threads_hammering_the_ring_never_share_a_slot():
    """More threads than cores, a short switch interval: a slot one thread
    fills is never out to another before it is released."""
    ring, m = _ring(limit=4)
    lock = threading.Lock()
    out = set()
    clashes = []
    n_threads, rounds = 12, 150

    def work(tid):
        for r in range(rounds):
            n = 1 + (tid + r) % 8
            chunk = np.full((n, *ROW), tid, np.float32)
            slot = ring.fill(chunk, 8, m.incr)
            with lock:
                if id(slot) in out:
                    clashes.append((tid, r))
                out.add(id(slot))
            if not (slot.array[:n] == tid).all() or slot.array[n:].any():
                clashes.append((tid, r, "contents"))
            with lock:
                out.discard(id(slot))
            ring.release(slot)
            slot.event.done = (tid + r) % 3 != 0

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
    assert not clashes
    assert sum(_counts(m)) == n_threads * rounds


class Doubler(Workload):
    name = "doubler"

    def bucket_ladder(self, max_batch):
        return [4, 8]

    def build(self, bucket):
        return lambda x: x * 2

    def placeholder(self, bucket):
        return np.zeros((bucket, *ROW), np.float32)


def test_cpu_core_keeps_the_pad_path():
    core = ExecutionCore(Doubler(), max_batch=8)
    assert core._staging is None
    x = _chunk(11)
    np.testing.assert_array_equal(core.infer(x), 2 * x)
    assert _counts(core.metrics) == (0, 0, 0)


def test_a_cuda_core_is_freed_without_the_cycle_collector():
    """The ring holds no reference back to its core: a dropped core frees
    its cached callables, and the device memory they hold, at once."""

    class OnCuda(Doubler):
        device = torch.device("cuda")

    core = ExecutionCore(OnCuda(), max_batch=8)
    assert core._staging is not None
    ref = weakref.ref(core)
    gc.disable()
    try:
        del core
        assert ref() is None
    finally:
        gc.enable()


class DoneEvent(FakeEvent):
    """A copy that is over as soon as it is enqueued (the CPU's)."""

    def record(self, stream=None):
        self.streams.append(stream)


def test_infer_stages_every_chunk_through_the_ring(monkeypatch):
    """The ring wired into ``infer`` as on CUDA (a synchronous callable
    here, so a slot is free again at once): every chunk is filled,
    released on the current stream and counted, answers unchanged."""
    core = ExecutionCore(Doubler(), max_batch=8)
    core._staging = ring = StagingRing(pin=False, new_event=DoneEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: "compute")
    pend = collections.deque()
    for n in (20, 3, 8, 5):                # chunks 8, 8, 4; 3; 8; 5
        x = _chunk(n, n)
        pend.append((x, core.infer(x, sync=False)))
    while pend:
        x, p = pend.popleft()
        np.testing.assert_array_equal(p.result(), 2 * x)
    assert _counts(core.metrics) == (4, 2, 0)     # one slot a bucket
    slot = ring.fill(_chunk(1), 8, core.metrics.incr)
    assert slot.event.streams == ["compute"] * 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ring stages only for one")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bucket,sizes", [(1024, (1000, 1024, 700, 1000)),
                                          (256, (200, 256, 13, 250))])
def test_async_infer_on_the_card_never_refills_a_slot_early(cuda, bucket,
                                                             sizes):
    """16 batches of different contents, four in flight, each copy to the
    card queued behind a ~1 ms sleep so that slots are refilled while
    earlier copies are pending: every answer equals the same batch served
    with ``sync=True`` on a fresh core."""
    from repro_torch.core import interaction_net as inet
    from repro_torch.data.jets import make_jets
    from repro_torch.serving.engine import TriggerWorkload

    cfg = inet.JediNetConfig()
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    rng = np.random.RandomState(3)
    xs = [make_jets(rng, sizes[i % len(sizes)], cfg.n_objects)[0]
          for i in range(16)]

    def core():
        return ExecutionCore(TriggerWorkload(params, cfg, device=cuda),
                             bucket_sizes=[bucket])

    served = core()
    pend, outs = collections.deque(), {}
    for i, x in enumerate(xs):
        if len(pend) == 4:
            j, p = pend.popleft()
            outs[j] = p.result()
        torch.cuda._sleep(2_000_000)
        pend.append((i, served.infer(x, sync=False)))
    while pend:
        j, p = pend.popleft()
        outs[j] = p.result()
    reused, grown, waited = _counts(served.metrics)
    assert reused + grown + waited == 16 and reused > 0
    for i, x in enumerate(xs):
        np.testing.assert_array_equal(outs[i], core().infer(x))
