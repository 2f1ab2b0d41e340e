"""The decode step's latent attention against its roofline, in percent.

The least time is the larger of the operations over the card's bf16 peak
and the bytes over its memory bandwidth, both counted by
``bench_port/work`` (``mla_decode_work``) from the traced slice's decoded
tokens and the cache positions they attended over (the program's
``lm.kv_positions``: 1,152 B a position a layer, plus each token's q and
output).  It is divided by the device time of the kernels the program
launched inside its ``lm.mla`` ranges (``bench_port/lm_trace.py``).
Nothing to read without those ranges or without the card's peaks."""


def read(m):
    under = getattr(m.trace, "under", {}).get("lm.mla")
    counts = m.trace.counts
    if m.peaks is None or not under or not counts.get("kv_positions"):
        return None
    ops, nbytes = m.work.mla_decode_work(m.config, counts["decode_tokens"],
                                         counts["kv_positions"])
    return 100.0 * m.work.roofline_seconds(ops, nbytes, m.peaks) / under[1]
