"""Share of the window's chunks that the engine staged into a reused slot,
in %: ``core.stage_reused`` over ``core.stage_reused``,
``core.stage_grown`` and ``core.stage_waited`` together, the counters
``ExecutionCore.infer`` (``serving/core.py``) bumps once a chunk on
CUDA, whether or not a profiler records.  A chunk is reused when the
oldest slot's copy to the card was done; grown when the ring added a
slot; waited when it was full and waited on the oldest slot's copy.

A program without these counters leaves the metric out (``None``)."""

KINDS = ("core.stage_reused", "core.stage_grown", "core.stage_waited")


def read(m):
    c = m.outcome.counters
    total = sum(c.get(k, 0) for k in KINDS)
    if not total:
        return None
    return 100.0 * c.get(KINDS[0], 0) / total
