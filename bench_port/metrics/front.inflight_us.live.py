"""Mean of the live front's ``loop.inflight`` stage, in us: a request's
time dispatched, from the dispatch of the plan that takes its last
events to its future turning done (``ServingLoop``,
``serving/loop.py``).

The program adds the nanoseconds to the counter ``loop.inflight.ns`` and one
to ``loop.inflight.n`` only while a profiler records, so the runner's counters
over the window hold the traced slice."""

PAIR = "loop.inflight"


def read(m):
    n = m.outcome.counters.get(PAIR + ".n")
    if not n:
        return None
    return m.outcome.counters.get(PAIR + ".ns", 0) / n / 1e3
