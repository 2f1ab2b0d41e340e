"""Mean time of the program's span ``core.d2h``, in us: a ready chunk's
logits copied to host memory and cut to its valid rows
(``PendingResult.result``, ``serving/core.py``).

The program adds the nanoseconds to the counter ``core.d2h.ns`` and one
to ``core.d2h.n`` only while a profiler records, so the runner's counters
over the window hold the traced slice."""

PAIR = "core.d2h"


def read(m):
    n = m.outcome.counters.get(PAIR + ".n")
    if not n:
        return None
    return m.outcome.counters.get(PAIR + ".ns", 0) / n / 1e3
