"""Mean time of the program's span ``core.stage``, in us: a chunk's host
batch made ready for the copy to the card, that is the pad to its
bucket (``Workload.pad``), then ``torch.from_numpy`` and
``pin_memory()`` (``ExecutionCore.infer``, ``serving/core.py``).

The program adds the nanoseconds to the counter ``core.stage.ns`` and one
to ``core.stage.n`` only while a profiler records, so the runner's counters
over the window hold the traced slice."""

PAIR = "core.stage"


def read(m):
    n = m.outcome.counters.get(PAIR + ".n")
    if not n:
        return None
    return m.outcome.counters.get(PAIR + ".ns", 0) / n / 1e3
