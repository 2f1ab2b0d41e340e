"""Mean of the live front's ``loop.queued`` stage, in us: a request's wait
in the batcher, from its submit to the cut of the plan that takes its
last events, on a full bucket or the fuse (``ServingLoop``,
``serving/loop.py``).

The program adds the nanoseconds to the counter ``loop.queued.ns`` and one
to ``loop.queued.n`` only while a profiler records, so the runner's counters
over the window hold the traced slice."""

PAIR = "loop.queued"


def read(m):
    n = m.outcome.counters.get(PAIR + ".n")
    if not n:
        return None
    return m.outcome.counters.get(PAIR + ".ns", 0) / n / 1e3
