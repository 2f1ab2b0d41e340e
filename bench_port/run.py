"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``,
``bench_port/`` and the program under ``src/repro_torch``.  The run
needs as many CUDA cards as the cell asks for and never falls back to
the CPU.  It prints diagnostic lines (the card, its power limit, the
window), the numbers the check compared beside their limits as the last
lines on standard error, and as the last line on standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``.

``--control tf32`` judges the reference in TF32 in the program's place,
``--control bf16`` serves through the program's bfloat16 path: the two
controls the comparison must fail (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

# Every build and kernel cache of the program at a fixed path inside the
# checkout (B1's library goes to build/kernels/ by the program's own rule).
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                   ("TRITON_CACHE_DIR", "build/triton"),
                   ("CUDA_CACHE_PATH", "build/nv_compute_cache")):
    os.environ[_var] = str(ROOT / _sub)
# One host thread for the math libraries: the load comes from one loop.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32", "bf16"), default=None)
    return ap.parse_args(argv)


def _power_limit():
    """Start ``nvidia-smi`` for the card's name and power limit; the
    caller waits for it."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def main(argv=None) -> int:
    args = _args(argv)
    smi = _power_limit()
    try:
        return _main(args, smi)
    finally:
        if smi is not None and smi.poll() is None:
            smi.kill()
            smi.wait()


def _main(args, smi) -> int:
    program = ROOT / "src" / "repro_torch"
    if not (ROOT / "BENCHMARK.json").is_file() or not program.is_dir():
        print(f"error: {ROOT} holds no BENCHMARK.json or no program under "
              "src/repro_torch", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench_port import harness, tracing
    cell = harness.resolve(harness.benchmark(ROOT), args.workload, ROOT)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    import repro_torch
    if pathlib.Path(repro_torch.__file__).resolve().parent != program:
        print(f"error: repro_torch loaded from {repro_torch.__file__}, not "
              f"{program}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_process = time.perf_counter() - harness.process_age_s()
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=device,
                      tracer=tracing.Tracer(bool(args.trace), device),
                      control=args.control, t_process=t_process)
    card = "unread"
    if smi is not None:
        out, _ = smi.communicate(timeout=60)
        card = out.strip().splitlines()[0] if out.strip() else "unread"
    run.log(f"card {torch.cuda.get_device_name(device)} x "
            f"{torch.cuda.device_count()} (nvidia-smi name, power limit: "
            f"{card}); torch {torch.__version__} cuda {torch.version.cuda}; "
            f"{cell.name} seed {args.seed} seconds {args.seconds} trace "
            f"{args.trace} control {args.control}")
    line = harness.execute(run)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"error: the run loaded {bad}: the benchmark measures the "
              "port, which must not load JAX or the JAX package",
              file=sys.stderr)
        return 4
    run.log(f"setup_s {run.setup_s:.3f}")
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
