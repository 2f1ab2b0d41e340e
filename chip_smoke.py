"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only, on one CUDA card, and exits
non-zero on any failure:

1. the card (``nvidia-smi`` name and power limit), the torch, CUDA and
   ``nvcc`` versions, and the kernels' build from the sources in the
   checkout (one ``nvcc`` per source, all started together);
2. every kernel against its plain PyTorch version on the card: jedi_30p
   in fp32, bf16 and int8, jedi_50p, jedi_tracks_128 with a sender tile
   that does not divide 128, odd batches, every activation — and two
   launches bitwise equal;
3. the main path: ``ResilientEngine(forward="fused_full")`` at jedi_30p
   serves a stream of 256-event batches and a few requests, with no
   demotion, the kernel's launch count advanced by every batch, and the
   served logits equal to plain ``sr_split`` on the card; then the same
   for ``int8_fused_full``; timing of the kernel beside its plain
   version and its bound.

Before the last line it prints one JSON object with each kernel's
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

#: Published peaks of one H100 SXM (NVIDIA data sheet, dense): fp32 on
#: the CUDA cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

#: fp32 and int8 paths: the repo's PathSpec.tolerance for the fused
#: kernels, on logits scaled to at least 1 (fp32's own rounding of a
#: logit of size L is ~6e-8 L, so large-logit configs compare relative).
TOL_FP32 = 5e-4
#: bf16, kernel vs plain both in bf16 on the card: identical bf16
#: operands, whose products are exact in fp32, summed in fp32 in another
#: order.  An fp32 sum that lands on the other side of a bf16 rounding
#: boundary moves that one activation by one bf16 ulp (2^-8 of it), which
#: reaches a logit only through one of its many summed terms, so a few
#: such flips stay well under 1e-3 of the logit scale.  A kernel that did
#: not round its activations to bf16 would land several times further
#: off: the bf16 case asserts that the same bf16 inputs run in fp32 all
#: through, by the kernel and by the plain version, lie more than
#: TOL_BF16 away.
TOL_BF16 = 1e-3

FAILURES: list[str] = []


def check(ok: bool, what: str) -> bool:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        FAILURES.append(what)
    return ok


def err_of(out, ref) -> tuple[float, float]:
    """(max abs error, max abs error over max(1, logit scale))."""
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    return err, err / scale


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events,
    after a warm-up)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def fused_full_work(cfg, batch: int) -> tuple[float, float]:
    """(operations, bytes) the whole-network function needs at ``batch``.

    Operations: 2 per multiply-add of every dense layer over the edges
    that exist (the self-edge is skipped), plus the sender sums; bytes:
    x and the fp32 weights read once, the logits written once."""
    p, n_o = cfg.n_features, cfg.n_objects
    fr = [2 * p, *cfg.fr_hidden, cfg.d_e]
    fo = [p + cfg.d_e, *cfg.fo_hidden, cfg.d_o]
    phi = [cfg.d_o, *cfg.phi_hidden, cfg.n_targets]
    h1 = fr[1]
    per_node = 2 * 2 * p * h1                       # u_r and u_s
    per_edge = sum(2 * a * b for a, b in zip(fr[1:-1], fr[2:])) \
        + 2 * h1 + cfg.d_e                          # split sum, sender sum
    tail = n_o * sum(2 * a * b for a, b in zip(fo[:-1], fo[1:])) \
        + sum(2 * a * b for a, b in zip(phi[:-1], phi[1:]))
    ops = batch * (n_o * per_node + n_o * (n_o - 1) * per_edge + tail)
    weights = sum(a * b + b for dims in (fr, fo, phi)
                  for a, b in zip(dims[:-1], dims[1:]))
    nbytes = 4 * (batch * n_o * p + weights + batch * cfg.n_targets)
    return ops, nbytes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import jedi_30p, jedi_50p, jedi_tracks_128
        from repro_torch.core import interaction_net as inet
        from repro_torch.core.int8_path import dequantize_params, \
            quantize_params_int8
        from repro_torch.data.jets import make_jets
        from repro_torch.kernels import build
        from repro_torch.kernels.fused_jedinet import full_kernel as FK
        from repro_torch.kernels.fused_jedinet import ops
        from repro_torch.serving.trigger import make_stream
        from repro_torch.serving.resilient import ResilientEngine
        from repro_torch.nn.core import ACTIVATIONS
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)

    # ---- 1. the card and the build --------------------------------------
    print("== 1. card and build")
    print(card)
    nvcc_ver = subprocess.run([build.find_nvcc(), "--version"],
                              capture_output=True, text=True).stdout
    print(f"  torch {torch.__version__}  cuda {torch.version.cuda}  nvcc "
          f"{nvcc_ver.strip().splitlines()[-1] if nvcc_ver else '?'}")
    libs = {"fused_jedinet_full": (FK.LIB_NAME, FK.SOURCES)}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        futs = {k: pool.submit(build.build_library, *v)
                for k, v in libs.items()}
        for k, f in futs.items():
            f.result()                    # raises with nvcc's output
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s")
    for k, v in libs.items():
        for line in build.build_log(*v).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k}: {line.strip()}")

    # ---- 2. kernel against its plain version ----------------------------
    print("== 2. kernel vs plain version on the card")

    def case(label, cfg, batch, *, quant=False, block_s=None,
             tol=TOL_FP32):
        params = inet.init(0, cfg, scale="lecun", device=dev)
        if quant:
            params = quantize_params_int8(params)
        x = torch.from_numpy(
            make_jets(np.random.RandomState(1), batch, cfg.n_objects)[0])
        bound = ops.bind_full(params, cfg)
        cdt = getattr(torch, cfg.compute_dtype)
        xk = x.to(dev).to(cdt).contiguous()
        kw = dict(activation=cfg.activation, n_targets=cfg.n_targets,
                  block_s=block_s)
        out = FK.fused_forward_full_kernel_call(xk, bound, **kw)
        again = FK.fused_forward_full_kernel_call(xk, bound, **kw)
        torch.cuda.synchronize()
        ref = FK.fused_forward_full_plain(
            xk, bound.fr, bound.fo, bound.phi, activation=cfg.activation,
            scales=bound.scales, block_s=block_s)
        err, rel = err_of(out, ref)
        lay = bound.launch_header(cfg.n_objects, cfg.n_targets, block_s)[0]
        check(out.shape == (batch, cfg.n_targets)
              and bool(torch.isfinite(out).all()) and rel <= tol
              and torch.equal(out, again),
              f"{label} B={batch}: max|err| {err:.3e} ({rel:.2e} of scale, "
              f"tol {tol:g}), repeat bitwise equal, layout epb="
              f"{lay.events_per_block} S={lay.block_s} ks={lay.ks} "
              f"team={lay.team} threads={lay.threads} smem={lay.smem_bytes}")
        return err, (xk, bound, kw)

    c30 = jedi_30p.MODEL
    for b in (1, 13, 257):
        case("jedi_30p fp32", c30, b)
    main_err, main_args = case("jedi_30p fp32", c30, 256)
    _, (xb, b16, kw16) = case("jedi_30p bf16",
                              c30.with_(compute_dtype="bfloat16"), 257,
                              tol=TOL_BF16)
    # The bf16 rounding itself is held: the same bf16 x and weights, run
    # in fp32 all through by the kernel and by the plain version, must
    # land further than TOL_BF16 from the bf16 kernel.
    b32 = FK.KernelWeights(
        fr=[t.float() for t in b16.fr], fo=[t.float() for t in b16.fo],
        phi=[t.float() for t in b16.phi], scales=None,
        n_features=b16.n_features).pack()
    kb = FK.fused_forward_full_kernel_call(xb, b16, **kw16)
    k32 = FK.fused_forward_full_kernel_call(xb.float(), b32, **kw16)
    unrounded = FK.fused_forward_full_plain(
        xb.float(), b32.fr, b32.fo, b32.phi, activation=kw16["activation"])
    torch.cuda.synchronize()
    gap_k, gap_k_rel = err_of(kb, k32)
    gap_p, gap_p_rel = err_of(kb, unrounded)
    check(gap_k_rel > TOL_BF16 and gap_p_rel > TOL_BF16,
          f"jedi_30p bf16 B=257: bf16 kernel vs the same inputs in fp32: "
          f"kernel {gap_k:.3e} ({gap_k_rel:.2e} of scale), plain "
          f"{gap_p:.3e} ({gap_p_rel:.2e}); both > tol {TOL_BF16:g}")
    case("jedi_30p int8", c30, 257, quant=True)
    case("jedi_50p fp32", jedi_50p.MODEL, 13)
    case("jedi_tracks_128 fp32 S=48", jedi_tracks_128.MODEL, 13, block_s=48)
    for act in ACTIVATIONS:
        if act != "relu":
            case(f"jedi_30p fp32 {act}", c30.with_(activation=act), 13)

    # ---- 3. the main path ------------------------------------------------
    print("== 3. main path: ResilientEngine on jedi_30p")
    batch, n_batches, n_infer = 256, 40, 4
    rng = np.random.RandomState(0)
    stream = make_stream(rng, n_batches, batch, c30.n_objects,
                         c30.n_features)
    requests = make_stream(rng, n_infer, batch, c30.n_objects,
                           c30.n_features)
    params = inet.init(0, c30, scale="lecun", device=dev)

    def serve(forward, ref_fn, ref_params):
        engine = ResilientEngine(params, c30, forward=forward, device="cuda",
                                 max_batch=batch)
        FK.fused_forward_full_kernel_call.launches = 0
        res = engine.run_stream(stream, warmup=2)
        served = [engine.infer(r) for r in requests]
        torch.cuda.synchronize()
        launches = FK.fused_forward_full_kernel_call.launches
        bucket = res["bucket"]
        health = engine.health()
        check(not health["counters"],
              f"{forward}: health counters {health['counters'] or 'none'} "
              f"(state {health['state']})")
        check(engine.active_path(bucket) == forward,
              f"{forward}: active path {engine.active_path(bucket)} at "
              f"bucket {bucket}")
        check(launches >= n_batches + n_infer,
              f"{forward}: kernel launches {launches} >= served batches "
              f"{n_batches + n_infer}")
        x = torch.from_numpy(requests[0]).to(dev)
        ref = ref_fn(ref_params, c30, x)
        err, rel = err_of(torch.from_numpy(served[0]).to(dev), ref)
        check(all(np.isfinite(s).all() and s.shape == (batch, c30.n_targets)
                  for s in served) and rel <= TOL_FP32,
              f"{forward}: served logits vs plain {ref_fn.__name__} "
              f"max|err| {err:.3e} ({rel:.2e} of scale, tol {TOL_FP32:g})")
        snap = engine.metrics.snapshot()
        print(f"  {forward}: {snap['kgps']:.1f} KGPS  p50 "
              f"{snap['p50_us']:.1f} us  p99 {snap['p99_us']:.1f} us per "
              f"{batch}-event batch ({res['events']} events, "
              f"{len(res['latencies'])} timed batches)  [{card}]")
        return launches, snap

    launches, snap = serve("fused_full", inet.forward_sr_split, params)
    q = quantize_params_int8(params)
    launches_int8, snap8 = serve(
        "int8_fused_full", inet.forward_sr_split, dequantize_params(q))

    xk, bound, kw = main_args
    ms = time_ms(lambda: FK.fused_forward_full_kernel_call(xk, bound, **kw),
                 200)
    plain_ms = time_ms(lambda: FK.fused_forward_full_plain(
        xk, bound.fr, bound.fo, bound.phi, activation=kw["activation"]), 20)
    flops, nbytes = fused_full_work(c30, xk.shape[0])
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"  fused_jedinet_full at jedi_30p B={xk.shape[0]} fp32: "
          f"{ms:.4f} ms/batch (plain version {plain_ms:.4f} ms); bound "
          f"{bound_ms:.4f} ms ({flops / 1e9:.3f} GFLOP at 67 TFLOP/s fp32 vs "
          f"{nbytes / 1e6:.3f} MB at 3.35 TB/s); no single PyTorch call "
          f"computes this function, so no library time  [{card}]")

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:",
              *FAILURES, sep="\n  ", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "fused_jedinet_full", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_jedinet_full.cu",
        "replaces": "src/repro/kernels/fused_jedinet/full_kernel.py:109",
        "launches": launches, "launches_int8": launches_int8,
        "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "serving": {"kgps": snap["kgps"], "p50_us": snap["p50_us"],
                    "p99_us": snap["p99_us"],
                    "int8_kgps": snap8["kgps"]},
        "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
