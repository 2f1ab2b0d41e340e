"""Kernel B1's share of its roofline, in percent.

The least time of a launch is the larger of its operations over the
card's peak in the configuration's precision and its bytes over the
card's memory bandwidth, both counted by ``bench_port/work`` for the
valid events of the launch (padding rows are no work).  It is divided by
B1's mean device time per launch, from the profiler's kernels whose names
hold ``jedi_fused_full``.  Nothing to read without such a launch or
without the card's peaks."""

KERNEL = "jedi_fused_full"


def read(m):
    if m.peaks is None:
        return None
    launches, seconds = 0, 0.0
    for name, (n, secs) in m.trace.device_ops.items():
        if KERNEL in name:
            launches += n
            seconds += secs
    events = m.trace.counts.get("events", 0)
    if not launches or seconds <= 0 or not events:
        return None
    ops, nbytes = m.work.launch_work(m.config["model"], events / launches)
    least = max(ops / m.peaks["flops_per_s"][m.config["compute_dtype"]],
                nbytes / m.peaks["bytes_per_s"])
    return 100.0 * least / (seconds / launches)
