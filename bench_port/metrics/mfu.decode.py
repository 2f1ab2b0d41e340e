"""The whole serve tick's share of the card's bf16 peak, in percent: the
model's operations for the traced slice's work (its decode steps at each
token's context, counted from the decoded tokens and the cache positions
they attended over, and its admissions' unpadded prefills), counted by
``bench_port/work``, over the slice's seconds times 989 TFLOP/s."""


def read(m):
    counts = m.trace.counts
    if m.peaks is None or m.trace.window_s <= 0 or not counts.get("tokens"):
        return None
    ops = m.work.decode_ops(m.config, counts.get("decode_tokens", 0),
                            counts.get("kv_positions", 0)) \
        + counts.get("prefill_ops", 0)
    return 100.0 * ops / (m.trace.window_s
                          * m.peaks["flops_per_s"]["bfloat16"])
