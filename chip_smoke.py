"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only, on one CUDA card, and exits
non-zero on any failure:

1. the card (``nvidia-smi`` name and power limit), the torch, CUDA and
   ``nvcc`` versions, and the kernels' build from the sources in the
   checkout (one ``nvcc`` per source, all started together), with each
   kernel's registers and spills;
2. every kernel against its plain PyTorch version on the card, and two
   launches bitwise equal:
   * B1 ``fused_jedinet_full`` and B2 ``jedi_linear_full``: jedi_30p in
     fp32 (odd batches too), bf16 (and that bf16 really rounds) and
     int8, jedi_50p (B1), jedi_tracks_128, every activation;
   * B3 ``fused_jedinet_edge``: jedi_30p in fp32 and bf16, jedi_50p and
     jedi_tracks_128;
3. the main paths through ``ResilientEngine``: ``fused_full`` and
   ``int8_fused_full`` (B1), ``jedi_linear_full`` at jedi_30p and
   jedi_tracks_128 and ``int8_jedi_linear_full`` (B2), and ``fused``
   (B3), each serving a stream of 256-event batches and a few requests
   with no demotion, no failure counter, the path's kernel launched for
   every served batch (all launch counts set to 0 just before the path
   is driven and read just after), and the served logits equal to the
   path's reference on the card;
4. each kernel's time at jedi_30p, 256 events, beside its plain
   version's time and its bound.

Before the last line it prints one JSON object with each kernel's
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import pathlib
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

#: Published peaks of one H100 SXM (NVIDIA data sheet, dense): fp32 on
#: the CUDA cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

#: fp32 and int8 paths: the repo's PathSpec.tolerance for the fused
#: kernels, on results scaled to at least 1 (fp32's own rounding of a
#: logit of size L is ~6e-8 L, so large-logit configs compare relative).
TOL_FP32 = 5e-4
#: bf16, kernel vs plain both in bf16 on the card: identical bf16
#: operands, whose products are exact in fp32, summed in fp32 in another
#: order.  An fp32 sum that lands on the other side of a bf16 rounding
#: boundary moves that one activation by one bf16 ulp (2^-8 of it), which
#: reaches a logit only through one of its many summed terms, so a few
#: such flips stay well under 1e-3 of the logit scale.  A kernel that did
#: not round its activations to bf16 would land several times further
#: off: the bf16 cases of B1 and B2 assert that the same bf16 inputs run
#: in fp32 all through, by the kernel and by the plain version, lie more
#: than TOL_BF16 away.
TOL_BF16 = 1e-3

FAILURES: list[str] = []


def check(ok: bool, what: str) -> bool:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        FAILURES.append(what)
    return ok


def err_of(out, ref) -> tuple[float, float]:
    """(max abs error, max abs error over max(1, result scale))."""
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


def _mlp_ops(dims) -> int:
    """2 operations per multiply-add of the dense layers ``dims``."""
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def _dims(cfg):
    p = cfg.n_features
    return ([2 * p, *cfg.fr_hidden, cfg.d_e],
            [p + cfg.d_e, *cfg.fo_hidden, cfg.d_o],
            [cfg.d_o, *cfg.phi_hidden, cfg.n_targets])


def _weight_words(*mlps) -> int:
    return sum(a * b + b for dims in mlps for a, b in zip(dims[:-1], dims[1:]))


def _edge_ops(cfg) -> int:
    """Operations of the edge block per event over the edges that exist
    (the self-edge is skipped): u_r and u_s per node, then per edge the
    split sum (2 adds per first-layer output), f_R's other layers and the
    sender sum."""
    fr = _dims(cfg)[0]
    n_o, h1 = cfg.n_objects, fr[1]
    per_edge = _mlp_ops(fr[1:]) + 2 * h1 + cfg.d_e
    return n_o * 2 * 2 * cfg.n_features * h1 + n_o * (n_o - 1) * per_edge


def _readout_ops(cfg) -> int:
    """f_O per node, the node sum and phi_O, per event."""
    _, fo, phi = _dims(cfg)
    return cfg.n_objects * (_mlp_ops(fo) + cfg.d_o) + _mlp_ops(phi)


def fused_full_work(cfg, batch: int) -> tuple[float, float]:
    """(operations, bytes) of the whole-network function at ``batch``:
    x and the fp32 weights read once, the logits written once."""
    ops = batch * (_edge_ops(cfg) + _readout_ops(cfg))
    nbytes = 4 * (batch * cfg.n_objects * cfg.n_features
                  + _weight_words(*_dims(cfg)) + batch * cfg.n_targets)
    return ops, nbytes


def edge_work(cfg, batch: int) -> tuple[float, float]:
    """(operations, bytes) of the edge block at ``batch``: x and f_R's
    fp32 weights read once, Ebar written once."""
    ops = batch * _edge_ops(cfg)
    nbytes = 4 * (batch * cfg.n_objects * (cfg.n_features + cfg.d_e)
                  + _weight_words(_dims(cfg)[0]))
    return ops, nbytes


def linear_work(cfg, batch: int) -> tuple[float, float]:
    """(operations, bytes) of the JEDI-linear function at ``batch``: per
    node u_r and u_s, the pool's add, the recombination (4 per output:
    add, scale, subtract, add) and f_R's other layers; then the readout.
    x and the fp32 weights read once, the logits written once."""
    fr = _dims(cfg)[0]
    h1 = fr[1]
    per_node = 2 * 2 * cfg.n_features * h1 + h1 + 4 * h1 + _mlp_ops(fr[1:])
    ops = batch * (cfg.n_objects * per_node + _readout_ops(cfg))
    nbytes = 4 * (batch * cfg.n_objects * cfg.n_features
                  + _weight_words(*_dims(cfg)) + batch * cfg.n_targets)
    return ops, nbytes


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel of the port, as this script drives it."""

    name: str
    source: str
    replaces: str
    lib: tuple                  # (library name, sources) for build.py
    bind: Callable              # (params, cfg) -> bound weights
    run: Callable               # (x, bound, cfg, block_s) -> result
    plain: Callable             # (x, bound, cfg, block_s) -> result
    layout: Callable            # (cfg, params, block_s) -> Layout
    counter: Callable           # the wrapper carrying .launches
    work: Callable              # (cfg, batch) -> (operations, bytes)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import jedi_30p, jedi_50p, jedi_tracks_128
        from repro_torch.core import interaction_net as inet
        from repro_torch.core import paths
        from repro_torch.core.int8_path import dequantize_params, \
            quantize_params_int8
        from repro_torch.data.jets import make_jets
        from repro_torch.kernels import build
        from repro_torch.kernels.fused_jedinet import autotune as fj_tune
        from repro_torch.kernels.fused_jedinet import full_kernel as FK
        from repro_torch.kernels.fused_jedinet import kernel as EK
        from repro_torch.kernels.fused_jedinet import ops
        from repro_torch.kernels.jedi_linear import autotune as jl_tune
        from repro_torch.kernels.jedi_linear import linear_kernel as LK
        from repro_torch.kernels.jedi_linear import ops as jl_ops
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

    csrc = "src/repro_torch/kernels/csrc/"
    b1 = Kernel(
        "fused_jedinet_full", csrc + "fused_jedinet_full.cu",
        "src/repro/kernels/fused_jedinet/full_kernel.py:109",
        (FK.LIB_NAME, FK.SOURCES), ops.bind_full,
        lambda x, b, cfg, bs: FK.fused_forward_full_kernel_call(
            x, b, activation=cfg.activation, n_targets=cfg.n_targets,
            block_s=bs),
        lambda x, b, cfg, bs: FK.fused_forward_full_plain(
            x, b.fr, b.fo, b.phi, activation=cfg.activation,
            scales=b.scales, block_s=bs),
        lambda cfg, p, bs: fj_tune.layout_for(cfg, p, block_s=bs),
        FK.fused_forward_full_kernel_call, fused_full_work)
    b2 = Kernel(
        "jedi_linear_full", csrc + "jedi_linear_full.cu",
        "src/repro/kernels/jedi_linear/linear_kernel.py:46",
        (LK.LIB_NAME, LK.SOURCES), jl_ops.bind_linear,
        lambda x, b, cfg, bs: LK.jedi_linear_kernel_call(
            x, b, activation=cfg.activation, n_targets=cfg.n_targets),
        lambda x, b, cfg, bs: LK.jedi_linear_forward_full_plain(
            x, b.fr, b.fo, b.phi, activation=cfg.activation,
            scales=b.scales),
        lambda cfg, p, bs: jl_tune.layout_for(cfg, p),
        LK.jedi_linear_kernel_call, linear_work)
    b3 = Kernel(
        "fused_jedinet_edge", csrc + "fused_jedinet_edge.cu",
        "src/repro/kernels/fused_jedinet/kernel.py:64",
        (EK.LIB_NAME, EK.SOURCES), lambda p, cfg: ops.bind_edge(p["fr"], cfg),
        lambda x, b, cfg, bs: EK.fused_edge_block_kernel_call(
            x, b, activation=cfg.activation, block_s=bs),
        lambda x, b, cfg, bs: EK.fused_edge_block_plain(
            x, b.fr, activation=cfg.activation, block_s=bs),
        lambda cfg, p, bs: fj_tune.edge_layout_for(cfg, p, block_s=bs),
        EK.fused_edge_block_kernel_call, edge_work)
    kernels = [b1, b2, b3]

    # ---- 1. the card and the build --------------------------------------
    print("== 1. card and build")
    print(card)
    nvcc_ver = subprocess.run([build.find_nvcc(), "--version"],
                              capture_output=True, text=True).stdout
    print(f"  torch {torch.__version__}  cuda {torch.version.cuda}  nvcc "
          f"{nvcc_ver.strip().splitlines()[-1] if nvcc_ver else '?'}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        futs = [pool.submit(build.build_library, *k.lib) for k in kernels]
        for f in futs:
            f.result()                    # raises with nvcc's output
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        for line in build.build_log(*k.lib).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.name}: {line.strip()}")

    # ---- 2. kernels against their plain versions ------------------------
    print("== 2. kernels vs plain versions on the card")

    def case(k, label, cfg, batch, *, quant=False, block_s=None,
             tol=TOL_FP32):
        params = inet.init(0, cfg, scale="lecun", device=dev)
        if quant:
            params = quantize_params_int8(params)
        x = torch.from_numpy(
            make_jets(np.random.RandomState(1), batch, cfg.n_objects)[0])
        bound = k.bind(params, cfg)
        cdt = getattr(torch, cfg.compute_dtype)
        xk = x.to(dev).to(cdt).contiguous()
        out = k.run(xk, bound, cfg, block_s)
        again = k.run(xk, bound, cfg, block_s)
        torch.cuda.synchronize()
        ref = k.plain(xk, bound, cfg, block_s)
        err, rel = err_of(out, ref)
        lay = k.layout(cfg, params, block_s)
        check(out.shape == ref.shape and out.shape[0] == batch
              and bool(torch.isfinite(out).all()) and rel <= tol
              and torch.equal(out, again),
              f"{k.name} {label} B={batch}: max|err| {err:.3e} ({rel:.2e} "
              f"of scale, tol {tol:g}), repeat bitwise equal, layout epb="
              f"{lay.events_per_block} S={lay.block_s} ks={lay.ks} "
              f"team={lay.team} threads={lay.threads} smem={lay.smem_bytes}")
        return err, (xk, bound, cfg)

    def bf16_rounds(k, args):
        """The bf16 rounding itself is held: the same bf16 x and weights,
        run in fp32 all through by the kernel and by the plain version,
        must land further than TOL_BF16 from the bf16 kernel."""
        xb, bb, cfg = args
        b32 = FK.KernelWeights(
            fr=[t.float() for t in bb.fr], fo=[t.float() for t in bb.fo],
            phi=[t.float() for t in bb.phi], scales=None,
            n_features=bb.n_features).pack()
        kb = k.run(xb, bb, cfg, None)
        k32 = k.run(xb.float(), b32, cfg, None)
        unrounded = k.plain(xb.float(), b32, cfg, None)
        torch.cuda.synchronize()
        gap_k, gap_k_rel = err_of(kb, k32)
        gap_p, gap_p_rel = err_of(kb, unrounded)
        check(gap_k_rel > TOL_BF16 and gap_p_rel > TOL_BF16,
              f"{k.name} jedi_30p bf16 B={xb.shape[0]}: bf16 kernel vs the "
              f"same inputs in fp32: kernel {gap_k:.3e} ({gap_k_rel:.2e} of "
              f"scale), plain {gap_p:.3e} ({gap_p_rel:.2e}); both > tol "
              f"{TOL_BF16:g}")

    c30, c50, c128 = jedi_30p.MODEL, jedi_50p.MODEL, jedi_tracks_128.MODEL
    bf30 = c30.with_(compute_dtype="bfloat16")
    main_args, main_err = {}, {}
    for k in (b1, b2):
        for b in (1, 13, 257):
            case(k, "jedi_30p fp32", c30, b)
        main_err[k.name], main_args[k.name] = case(k, "jedi_30p fp32", c30,
                                                   256)
        bf16_rounds(k, case(k, "jedi_30p bf16", bf30, 257, tol=TOL_BF16)[1])
        case(k, "jedi_30p int8", c30, 257, quant=True)
        for act in ACTIVATIONS:
            if act != "relu":
                case(k, f"jedi_30p fp32 {act}", c30.with_(activation=act), 13)
    case(b1, "jedi_50p fp32", c50, 13)
    case(b1, "jedi_tracks_128 fp32 S=48", c128, 13, block_s=48)
    case(b2, "jedi_tracks_128 fp32", c128, 13)
    main_err[b3.name], main_args[b3.name] = case(b3, "jedi_30p fp32", c30,
                                                 256)
    case(b3, "jedi_30p bf16", bf30, 257, tol=TOL_BF16)
    case(b3, "jedi_50p fp32", c50, 13)
    case(b3, "jedi_tracks_128 fp32", c128, 13)

    # ---- 3. the main paths -------------------------------------------------
    print("== 3. main paths: ResilientEngine")
    batch, n_infer = 256, 4
    rng = np.random.RandomState(0)

    def serve(forward, k, cfg, n_batches, ref_fn=None, ref_params=None):
        """Serve ``forward`` at ``cfg``; check it and return the launches
        of its kernel ``k`` in this run and the metrics snapshot.  The
        served logits are held against ``ref_fn`` (the path's registered
        ``ref`` by default) at the path's tolerance."""
        spec = paths.get(forward)
        params = inet.init(0, cfg, scale="lecun", device=dev)
        if ref_fn is None:
            ref_fn, ref_params = spec.ref, spec.prepare_params(params)
        stream = make_stream(rng, n_batches, batch, cfg.n_objects,
                             cfg.n_features)
        requests = make_stream(rng, n_infer, batch, cfg.n_objects,
                               cfg.n_features)
        engine = ResilientEngine(params, cfg, forward=forward, device="cuda",
                                 max_batch=batch)
        for kk in kernels:
            kk.counter.launches = 0
        res = engine.run_stream(stream, warmup=2)
        served = [engine.infer(r) for r in requests]
        torch.cuda.synchronize()
        launches = k.counter.launches
        bucket = res["bucket"]
        health = engine.health()
        label = f"{forward} n_o={cfg.n_objects}"
        check(not health["counters"],
              f"{label}: health counters {health['counters'] or 'none'} "
              f"(state {health['state']})")
        check(engine.active_path(bucket) == forward,
              f"{label}: active path {engine.active_path(bucket)} at "
              f"bucket {bucket}")
        check(launches >= n_batches + n_infer,
              f"{label}: {k.name} launches {launches} >= served batches "
              f"{n_batches + n_infer}")
        x = torch.from_numpy(requests[0]).to(dev)
        ref = ref_fn(ref_params, cfg, x)
        err, rel = err_of(torch.from_numpy(served[0]).to(dev), ref)
        check(all(np.isfinite(s).all() and s.shape == (batch, cfg.n_targets)
                  for s in served) and rel <= spec.tolerance,
              f"{label}: served logits vs plain {ref_fn.__name__} "
              f"max|err| {err:.3e} ({rel:.2e} of scale, tol "
              f"{spec.tolerance:g})")
        snap = engine.metrics.snapshot()
        print(f"  {label}: {snap['kgps']:.1f} KGPS  p50 "
              f"{snap['p50_us']:.1f} us  p99 {snap['p99_us']:.1f} us per "
              f"{batch}-event batch in bucket {bucket} ({res['events']} "
              f"events, {len(res['latencies'])} timed batches)  [{card}]")
        return launches, snap

    p30 = inet.init(0, c30, scale="lecun", device=dev)
    serving = {
        "fused_full": serve("fused_full", b1, c30, 40, inet.forward_sr_split,
                            p30),
        "int8_fused_full": serve(
            "int8_fused_full", b1, c30, 40, inet.forward_sr_split,
            dequantize_params(quantize_params_int8(p30))),
        "jedi_linear_full": serve("jedi_linear_full", b2, c30, 40),
        "jedi_linear_full_tracks_128": serve("jedi_linear_full", b2, c128,
                                             12),
        "int8_jedi_linear_full": serve("int8_jedi_linear_full", b2, c30, 40),
        "fused": serve("fused", b3, c30, 40),
    }
    main_path = {b1.name: "fused_full", b2.name: "jedi_linear_full",
                 b3.name: "fused"}

    # ---- 4. timing ----------------------------------------------------------
    print("== 4. kernel timing (CUDA events)")
    rows = []
    for k in kernels:
        xk, bound, cfg = main_args[k.name]
        ms = time_ms(lambda: k.run(xk, bound, cfg, None), 200)
        plain_ms = time_ms(lambda: k.plain(xk, bound, cfg, None), 20)
        ops_, nbytes = k.work(cfg, xk.shape[0])
        t_ops = ops_ / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        print(f"  {k.name} at jedi_30p B={xk.shape[0]} fp32: {ms:.4f} "
              f"ms/batch (plain version {plain_ms:.4f} ms); bound "
              f"{bound_ms:.4f} ms ({ops_ / 1e9:.4f} GFLOP at 67 TFLOP/s "
              f"fp32 vs {nbytes / 1e6:.3f} MB at 3.35 TB/s); no single "
              f"PyTorch call computes this function, so no library time  "
              f"[{card}]")
        launches, snap = serving[main_path[k.name]]
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches,
            "max_abs_err": main_err[k.name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "main_path": main_path[k.name],
            "serving": {"kgps": snap["kgps"], "p50_us": snap["p50_us"],
                        "p99_us": snap["p99_us"]},
            "card": card})
    # B2 at its widest shape, for the record beside its bound
    params = inet.init(0, c128, scale="lecun", device=dev)
    x = torch.from_numpy(make_jets(np.random.RandomState(1), batch,
                                   c128.n_objects)[0]).to(dev)
    bound = b2.bind(params, c128)
    ms128 = time_ms(lambda: b2.run(x, bound, c128, None), 50)
    ops_, nbytes = linear_work(c128, batch)
    bound128 = max(ops_ / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    print(f"  jedi_linear_full at jedi_tracks_128 B={batch} fp32: "
          f"{ms128:.4f} ms/batch; bound {bound128:.4f} ms ({ops_ / 1e9:.4f} "
          f"GFLOP)  [{card}]")
    rows[1]["tracks_128"] = {"ms": ms128, "bound_ms": bound128}
    for key, (launches, snap) in serving.items():
        print(f"  served {key}: {launches} launches, {snap['kgps']:.1f} KGPS")

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:",
              *FAILURES, sep="\n  ", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
