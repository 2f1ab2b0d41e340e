"""Mean time of the program's span ``core.wait``, in us: the wait for a
dispatched chunk's result, on its event or the watchdog's thread
(``PendingResult.result``, ``serving/core.py``).

The program adds the nanoseconds to the counter ``core.wait.ns`` and one
to ``core.wait.n`` only while a profiler records, so the runner's counters
over the window hold the traced slice."""

PAIR = "core.wait"


def read(m):
    n = m.outcome.counters.get(PAIR + ".n")
    if not n:
        return None
    return m.outcome.counters.get(PAIR + ".ns", 0) / n / 1e3
