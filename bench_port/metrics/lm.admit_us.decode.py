"""Mean time of the program's span ``lm.admit``, in us: one admission,
its ladder-padded prefill, the splice of its cache rows into the slot and
its first token on the host (``LMEngine._admit``, ``serving/lm.py``).

Counted as ``lm.decode_us.decode`` is, only while a profiler records."""

PAIR = "lm.admit"


def read(m):
    n = m.outcome.counters.get(PAIR + ".n")
    if not n:
        return None
    return m.outcome.counters.get(PAIR + ".ns", 0) / n / 1e3
