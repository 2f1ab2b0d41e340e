"""Mean time of the program's span ``core.h2d``, in us: enqueueing a
staged chunk's copy to the card, ``.to(device, non_blocking=True)``
(``ExecutionCore.infer``, ``serving/core.py``).

The program adds the nanoseconds to the counter ``core.h2d.ns`` and one
to ``core.h2d.n`` only while a profiler records, so the runner's counters
over the window hold the traced slice."""

PAIR = "core.h2d"


def read(m):
    n = m.outcome.counters.get(PAIR + ".n")
    if not n:
        return None
    return m.outcome.counters.get(PAIR + ".ns", 0) / n / 1e3
