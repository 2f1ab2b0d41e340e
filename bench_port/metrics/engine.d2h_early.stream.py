"""Share of the window's chunks whose logits the engine copied into a
pinned host slot right behind their launch, in %: ``core.d2h_early``
over ``core.d2h_early`` and ``core.d2h_late`` together, the counters
``PendingResult.result`` (``serving/core.py``) bumps once a chunk
realized on CUDA, whether or not a profiler records.  Early: the copy
was enqueued at launch and the realize read host memory only; late: the
realize copied the logits from the card.

A program without these counters leaves the metric out (``None``)."""

KINDS = ("core.d2h_early", "core.d2h_late")


def read(m):
    c = m.outcome.counters
    total = sum(c.get(k, 0) for k in KINDS)
    if not total:
        return None
    return 100.0 * c.get(KINDS[0], 0) / total
