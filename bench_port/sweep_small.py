"""Find the knee of ``jedinet-30p.live_small``: ``sweep.py``'s rule and
output over ``runners/live_small.py``'s size draw (``sweep.py`` drives
``runners/live.py``'s uniform one).

    python3 bench_port/sweep_small.py --workload jedinet-30p.live_small \\
        --seed 7 --seconds 10 --rates 2000,3000,4000
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import sweep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    root = sweep.bench_run.ROOT
    sys.path[:0] = [str(root), str(root / "src")]
    import numpy as np
    import torch

    from bench_port import harness, tracing
    from bench_port.runners import live, live_small
    cell = harness.resolve(harness.benchmark(root), args.workload, root)
    if not torch.cuda.is_available():
        print("error: the sweep needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=False, device=device,
                      tracer=tracing.Tracer(False, device),
                      t_process=time.perf_counter())
    setup = live_small.prepare(run)
    knee = 0.0
    for rate in sorted(float(r) for r in args.rates.split(",")):
        sched, served, counters = live_small.window(run, setup, rate,
                                                    args.seconds, trace=False)
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
            sustained=sweep.sustained(reading))
        print(json.dumps(reading), flush=True)
        if not reading["sustained"]:
            break
        knee = rate
    print(json.dumps({"workload": cell.name,
                      "card": torch.cuda.get_device_name(device),
                      "knee_per_s": knee,
                      "rate_per_s": sweep.round_down(0.8 * knee)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
