"""The card's idle share of the LM cell's traced slice, in percent: one
minus the union of its kernel, copy and set intervals over the slice (the
program's ranges are annotations, not work: ``bench_port/lm_trace.py``)."""


def read(m):
    if m.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
