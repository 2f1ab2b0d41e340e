"""Find the knee of a live cell: the highest offered rate it sustains.

    python3 bench_port/sweep.py --workload jedinet-30p.live --seed 7 \\
        --seconds 10 --rates 800,1200,1600,2000

One process on one card: the cell's set-up once, then one window per
rate, lowest first.  A rate is sustained when the requests completed
within the window come to at least 98% of those offered and the mean
backlog (requests due and not yet done: the batcher's queue and the
requests waiting behind a submit that blocks) in the window's second
half is not above 1.5x that of its first half plus 5 requests.  The knee is the highest
rate that is sustained with every lower rate; the cell's rate is 0.8x
the knee, rounded down to two significant figures.  Prints one JSON
line per rate and a last line with the knee.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import run as bench_run  # noqa: F401  (sets the caches and thread counts)


def sustained(reading: dict) -> bool:
    return (reading["completed_per_s"] >= 0.98 * reading["offered_per_s"]
            and reading["backlog_second"]
            <= 1.5 * reading["backlog_first"] + 5)


def round_down(x: float) -> int:
    if x <= 0:
        return 0
    step = 10 ** max(0, int(math.floor(math.log10(x))) - 1)
    return int(x // step * step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    root = bench_run.ROOT
    sys.path[:0] = [str(root), str(root / "src")]
    import numpy as np
    import torch

    from bench_port import harness, tracing
    from bench_port.runners import live
    cell = harness.resolve(harness.benchmark(root), args.workload, root)
    if not torch.cuda.is_available():
        print("error: the sweep needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=False, device=device,
                      tracer=tracing.Tracer(False, device),
                      t_process=time.perf_counter())
    setup = live.prepare(run)
    knee = 0.0
    for rate in sorted(float(r) for r in args.rates.split(",")):
        sched, served, counters = live.window(run, setup, rate, args.seconds,
                                              trace=False)
        reading = live.knee_reading(sched, served, args.seconds)
        lat = (served.done_at - sched.due) * 1e6
        done = lat[~np.isnan(lat)]
        reading.update(
            rate=rate, requests=len(sched.due),
            unfinished=int(np.isnan(lat).sum()),
            p50_us=float(np.percentile(done, 50)),
            p99_us=float(np.percentile(done, 99)),
            plans=counters.get("loop_plans", 0),
            events_per_plan=float(sched.sizes.sum())
            / max(1, counters.get("loop_plans", 0)),
            late_p99_us=float(np.percentile(served.late_s, 99) * 1e6),
            sustained=sustained(reading))
        print(json.dumps(reading), flush=True)
        if not reading["sustained"]:
            break
        knee = rate
    print(json.dumps({"workload": cell.name,
                      "card": torch.cuda.get_device_name(device),
                      "knee_per_s": knee,
                      "rate_per_s": round_down(0.8 * knee)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
