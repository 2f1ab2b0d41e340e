"""The whole serve step's share of the card's peak, in percent: the
operations of the valid events dispatched in the traced slice (counted
by ``bench_port/work``, whatever implements them) over the slice's
seconds times the card's peak in the configuration's precision (fp32:
67 TFLOP/s outside the tensor cores on the data sheet)."""


def read(m):
    if m.peaks is None or m.trace.window_s <= 0:
        return None
    events = m.trace.counts.get("events", 0)
    if not events:
        return None
    ops = events * m.work.ops_per_event(m.config["model"])
    peak = m.peaks["flops_per_s"][m.config["compute_dtype"]]
    return 100.0 * ops / (m.trace.window_s * peak)
