"""Trigger-tier CLI: the logic behind ``repro_torch.launch.trigger_serve``.

Port of ``repro.serving.trigger``.  The launch module is a thin shell
(argparse plus one call in here):

* :func:`make_stream` — synthetic event stream, fully materialized so
  generation stays off the timed path;
* :func:`run_trigger_cli` — the whole serve flow: registry listing,
  fault drills through the guarded per-request path, the double-buffered
  stream run with its H100 roofline line, and the health report;
* :func:`print_health` — the health state machine's operator view.

``--device`` picks the card (``cuda``, the default) or ``cpu``; asking
for ``cuda`` without a card raises.  ``--sentinel`` arms the
silent-corruption sentinel with synchronous shadows.

One departure from the reference's printout: the roofline line bills the
step at the operand width of the engine's ``--compute-dtype`` (4 bytes
for float32, 2 for bfloat16), so an fp32 run is held against the
H100's fp32 peak, not its bf16 tensor-core peak, 15x higher.  The
reference bills every run at 2 bytes, where the TPU has one peak.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core import paths
from repro_torch.core.interaction_net import JediNetConfig, init
from repro_torch.data.jets import make_jets
from repro_torch.serving.faults import SILENT_SEAMS, FaultInjector
from repro_torch.serving.resilient import ResilientEngine
from repro_torch.serving.sentinel import SentinelConfig

def make_stream(rng, n_batches: int, batch: int, n_objects: int,
                n_features: int):
    """Pre-generated synthetic event stream (host numpy batches)."""
    return [make_jets(rng, batch, n_objects, n_features)[0]
            for _ in range(n_batches)]


def print_health(engine) -> None:
    """The health state machine's operator view (``--health``)."""
    h = engine.health()
    print(f"[health] state={h['state']} base={h['base_path']} "
          f"chain={'>'.join(h['chain'])} inflight={h['inflight']}")
    for bucket, st in h["buckets"].items():
        probe = ("-" if st["next_probe_in_s"] is None
                 else f"{st['next_probe_in_s']:.2f}s")
        quarantine = ""
        if st.get("quarantined"):
            quarantine = (f" QUARANTINED[{st['quarantined_path']}] "
                          f"clean_canaries={st['clean_canaries']}")
        print(f"  bucket {bucket:>5}: path={st['path']} level={st['level']} "
              f"demotions={st['demotions']} next_probe_in={probe}"
              f"{quarantine}{' DOWN' if st['down'] else ''}")
    if h.get("sentinel"):
        s = h["sentinel"]
        print(f"  sentinel: canary_every={s['canary_every']} "
              f"shadow_rate={s['shadow_rate']:g} "
              f"promote_after={s['promote_after']}")
    if h["counters"]:
        print("  counters: " + " ".join(f"{k}={v}"
                                        for k, v in h["counters"].items()))
    else:
        print("  counters: (none)")
    if h.get("gauges"):
        print("  gauges:   " + " ".join(f"{k}={v:g}"
                                        for k, v in h["gauges"].items()))


def parse_drills(specs, injector, path) -> None:
    """Arm ``SEAM[:TIMES[:MAGNITUDE]]`` drill specs against ``path``: a
    delay in seconds for the timed seams (``latency``, ``stuck``), a
    corruption factor for the silent seams."""
    for spec in specs:
        parts = spec.split(":")
        seam = parts[0]
        times = float(parts[1]) if len(parts) > 1 else 1.0
        if seam in SILENT_SEAMS:
            factor = float(parts[2]) if len(parts) > 2 else 4.0
            injector.arm(seam, path=path, times=times, factor=factor)
        else:
            delay = float(parts[2]) if len(parts) > 2 else 0.05
            injector.arm(seam, path=path, times=times, delay_s=delay)


def build_trigger_cli(ap) -> None:
    """Install the trigger-serve arguments on an ``argparse`` parser."""
    ap.add_argument("--n-objects", type=int, default=30)
    ap.add_argument("--n-features", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256,
                    help="events per stream tick (the trigger's time slice)")
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--forward", default="fused_full",
                    choices=paths.available())
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="serve on the CUDA card (default; raises without "
                         "one) or on the CPU with the plain versions")
    ap.add_argument("--list-paths", action="store_true",
                    help="print the forward-path registry and exit")
    ap.add_argument("--health", action="store_true",
                    help="print the engine health report after the run")
    ap.add_argument("--drill", action="append", default=None,
                    metavar="SEAM[:TIMES[:MAGNITUDE]]",
                    help="arm a fault against the primary path (repeatable) "
                         "and serve through the guarded per-request path. "
                         "Loud seams: compile, dispatch, input_nan, "
                         "output_nan, latency, stuck (MAGNITUDE = delay "
                         "seconds).  Silent seams: scale_drift, "
                         "weight_corrupt, stale_cache (MAGNITUDE = "
                         "corruption factor) — pair them with --sentinel "
                         "or they serve wrong answers undetected")
    ap.add_argument("--sentinel", action="store_true",
                    help="arm the silent-corruption sentinel: golden "
                         "canaries, terminal-rung shadow re-execution, "
                         "canary-gated quarantine (see --health)")
    ap.add_argument("--shadow-rate", type=float, default=1 / 16,
                    help="sentinel shadow re-execution duty cycle "
                         "(fraction of live requests; 0 disables shadows)")
    ap.add_argument("--canary-every", type=int, default=16,
                    help="sentinel canary cadence in requests per bucket")
    ap.add_argument("--watchdog-s", type=float, default=30.0,
                    help="stuck-dispatch watchdog budget")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-tick serve deadline (drill path); expired "
                         "ticks are shed, not dispatched")
    ap.add_argument("--seed", type=int, default=0)


def run_trigger_cli(args) -> None:
    """Serve a synthetic stream per parsed ``args`` and print the report."""
    cfg = JediNetConfig(n_objects=args.n_objects, n_features=args.n_features,
                        compute_dtype=args.compute_dtype)
    if args.list_paths:
        params = init(args.seed, cfg, device="cpu")
        print(paths.describe(cfg=cfg, params=params,
                             max_batch=max(args.batch, 1)))
        return

    params = init(args.seed, cfg, device=args.device)
    injector = None
    if args.drill:
        injector = FaultInjector()
        parse_drills(args.drill, injector, args.forward)
    sentinel = None
    if getattr(args, "sentinel", False):
        # sync shadows: the verdict (quarantines= in --health) must be
        # complete when the run prints, not racing a worker
        sentinel = SentinelConfig(canary_every=args.canary_every,
                                  shadow_rate=args.shadow_rate,
                                  shadow_sync=True)
    engine = ResilientEngine(params, cfg, forward=args.forward,
                             device=args.device,
                             max_batch=max(args.batch, 1),
                             injector=injector,
                             watchdog_s=args.watchdog_s,
                             sentinel=sentinel)

    rng = np.random.RandomState(args.seed)
    stream = make_stream(rng, args.batches, args.batch, args.n_objects,
                         args.n_features)

    if args.drill:
        # guarded per-request path: every batch rides the full ladder
        served = shed = 0
        t0 = time.perf_counter()
        for tick in stream:
            deadline = (None if args.deadline_ms is None
                        else engine._clock() + args.deadline_ms * 1e-3)
            out = engine.infer(tick, deadline=deadline)
            if out is None:
                shed += 1
            else:
                served += 1
        wall = time.perf_counter() - t0
        snap = engine.metrics.snapshot()
        print(f"[trigger_serve] DRILL forward={args.forward} "
              f"faults={','.join(args.drill)} ticks={args.batches} "
              f"served={served} shed={shed} wall={wall:.3f}s")
        print(f"  latency    p50 {snap['p50_us']:8.1f} us   "
              f"p99 {snap['p99_us']:8.1f} us  per batch")
        print_health(engine)
        return

    res = engine.run_stream(stream, warmup=args.warmup)

    if not res["latencies"]:
        print("[trigger_serve] stream too short for stats "
              f"(need > warmup={args.warmup} batches, got {args.batches})")
        if args.health:
            print_health(engine)
        return

    snap = engine.metrics.snapshot()
    bucket = res["bucket"]
    model = engine.roofline([bucket])[bucket]
    print(f"[trigger_serve] forward={args.forward} "
          f"n_objects={args.n_objects} batch={args.batch} bucket={bucket} "
          f"dtype={args.compute_dtype} shards={engine.n_shards} "
          f"device={args.device}")
    print(f"  sustained  {snap['kgps']:8.1f} KGPS  "
          f"({res['events']} events / {res['wall_s']:.3f} s)")
    print(f"  latency    p50 {snap['p50_us']:8.1f} us   "
          f"p99 {snap['p99_us']:8.1f} us  per batch")
    print(f"  per-event  p50 {snap['per_event_p50_us']:8.3f} us")
    print(f"  roofline   modeled {model['step_us']:.1f} us/step "
          f"({model['bound']}-bound, {model['hbm_bytes'] / 1e6:.2f} MB HBM, "
          f"level={model['fused_level']}, H100 peak "
          f"{model['peak_flops'] / 1e12:g} TFLOP/s at "
          f"{model['compute_bytes']} B/operand)")
    print(f"  serving    path={engine.active_path(bucket)} "
          f"(chain {'>'.join(engine.chain)})")
    if args.health:
        print_health(engine)
