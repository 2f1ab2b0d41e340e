"""Mean of the live front's ``loop.blocked`` stage, in us: a request's
wait for an in-flight slot, from the cut of the plan that takes its last
events to that plan's dispatch (``ServingLoop``, ``serving/loop.py``).

The program adds the nanoseconds to the counter ``loop.blocked.ns`` and one
to ``loop.blocked.n`` only while a profiler records, so the runner's counters
over the window hold the traced slice."""

PAIR = "loop.blocked"


def read(m):
    n = m.outcome.counters.get(PAIR + ".n")
    if not n:
        return None
    return m.outcome.counters.get(PAIR + ".ns", 0) / n / 1e3
