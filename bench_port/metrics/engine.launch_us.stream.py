"""Mean time of the program's span ``core.launch``, in us: enqueueing the
rung's kernels on a staged chunk and recording its result's event
(``ExecutionCore.infer``, ``serving/core.py``).

The program adds the nanoseconds to the counter ``core.launch.ns`` and one
to ``core.launch.n`` only while a profiler records, so the runner's counters
over the window hold the traced slice."""

PAIR = "core.launch"


def read(m):
    n = m.outcome.counters.get(PAIR + ".n")
    if not n:
        return None
    return m.outcome.counters.get(PAIR + ".ns", 0) / n / 1e3
