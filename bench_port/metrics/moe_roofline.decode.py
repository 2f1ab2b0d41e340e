"""The decode step's routed and shared experts against their roofline, in
percent.

The least time is the larger of the operations over the card's bf16 peak
and the bytes over its memory bandwidth, counted by ``bench_port/work``
(``moe_decode_work``) for the traced slice's decode steps and tokens:
each touched expert's weights read once a step a layer (at 96 tokens all
64 are touched but for 0.005 expected), the shared experts and the router
too.  It is divided by the device time of the kernels the program
launched inside its ``lm.moe`` ranges."""


def read(m):
    under = getattr(m.trace, "under", {}).get("lm.moe")
    counts = m.trace.counts
    if m.peaks is None or not under or not counts.get("decode_steps"):
        return None
    ops, nbytes = m.work.moe_decode_work(m.config, counts["decode_steps"],
                                         counts["decode_tokens"])
    return 100.0 * m.work.roofline_seconds(ops, nbytes, m.peaks) / under[1]
