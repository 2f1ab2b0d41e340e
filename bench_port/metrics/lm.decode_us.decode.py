"""Mean time of the program's span ``lm.decode``, in us: a scheduler
tick's decode step, from the call of the decode callable to its tokens on
the host (``LMEngine.step``, ``serving/lm.py``).

The program adds the nanoseconds to the counter ``lm.decode.ns`` and one
to ``lm.decode.n`` only while a profiler records, so the runner's
counters over the window hold the traced slice."""

PAIR = "lm.decode"


def read(m):
    n = m.outcome.counters.get(PAIR + ".n")
    if not n:
        return None
    return m.outcome.counters.get(PAIR + ".ns", 0) / n / 1e3
