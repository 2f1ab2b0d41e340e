"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only, on one CUDA card, and exits
non-zero on any failure:

1. the card (``nvidia-smi`` name and power limit), the torch, CUDA and
   ``nvcc`` versions, and the five kernels' build from the sources in the
   checkout (one ``nvcc`` per source, all started together), with each
   kernel's registers and spills, and no spills in the register-resident
   JEDI kernels that jedi_30p and jedi_50p run;
2. every kernel against its plain PyTorch version on the card, and two
   launches bitwise equal, with the design each JEDI case runs:
   * B1 ``fused_jedinet_full`` and B2 ``jedi_linear_full``: jedi_30p in
     fp32 (odd batches too), bf16 (and that bf16 really rounds) and
     int8, jedi_50p, jedi_tracks_128, every activation;
   * B3 ``fused_jedinet_edge``: jedi_30p in fp32 at B = 1, 13, 256 and
     257 and in bf16 (and that bf16 really rounds), jedi_30p with a
     pinned sender tile (the team layout), jedi_50p and jedi_tracks_128;
   * B4 ``fm_interaction``: unit-normal v in fp32 and bf16 at B = 1, 7,
     513 and 262,144 (F=39, K=10, the ``fm`` config) and at F=26, K=16;
   * B5 ``flash_decode``: the reference's three sweep shapes, D=80 at
     G=4, a sliding window, a bf16 cache, S not a multiple of the tile,
     a row with no valid key (with one partition and with many), and
     h2o-danube-1.8b's decode_32k shape at B=1 and B=2, where many
     sequence partitions combine;
3. the main paths, each with all launch counts set to 0 just before it
   is driven and read just after:
   * ``fused_full`` and ``int8_fused_full`` (B1), ``jedi_linear_full``
     at jedi_30p and jedi_tracks_128 and ``int8_jedi_linear_full`` (B2),
     and ``fused`` (B3) through ``ResilientEngine``, each serving a
     stream of 256-event batches and a few requests with no demotion, no
     failure counter, the batches in bucket 256, the path's kernel
     launched once for every served batch, and the served logits equal
     to the path's reference on the card;
   * FM scoring at the full ``fm`` width (90.2M embedding rows on the
     card): ``models.recsys.forward(use_kernel=True)`` on ``ctr_batches``
     ids at ``serve_p99`` (B=512) and ``serve_bulk`` (B=262,144), one B4
     launch per call, against ``forward(use_kernel=False)`` with the
     init table and with unit-normal rows; ``retrieval_score`` at
     ``retrieval_cand`` (1 x 1,000,000) against ``forward`` on a sample
     of candidates;
   * ``kernels.flash_decode.ops.flash_decode`` at h2o-danube-1.8b's
     ``decode_32k`` shape (B=128, S=32,768, H=32, Hkv=8, D=80, bf16
     cache) for a few decode steps, against its plain version;
4. each kernel's time at its main path's shape beside its plain
   version's time, its bound and, where one PyTorch call computes the
   same function, that call's time (``scaled_dot_product_attention`` for
   B5): CUDA events around back-to-back eager launches, the median of 5
   windows with their spread; for B1-B3 also
   the device time per launch from ``torch.profiler`` and from a CUDA
   graph of 20 launches (the eager loop can measure the host's enqueue
   at these sizes); B1's and B3's team designs beside their warp
   designs; the JEDI kernels' designs per case and B5's partitions,
   stages and path;
5. the trigger's serving front at jedi_30p fp32 through
   ``ResilientEngine``, each run with the launch counts set to 0 just
   before it and read just after (B1's and B2's launches here join
   their main-path counts):
   * the silent-seam drill, one engine per (path, seam):
     ``scale_drift`` on ``int8_fused_full``, ``weight_corrupt`` and
     ``stale_cache`` on ``fused_full``, ``weight_corrupt`` on
     ``jedi_linear_full``; each detected at live batch 1, requalified
     by batch 9, no loud counter, final state healthy, with its peak and
     clean ``canary_dev`` printed;
   * asynchronous shadows on the sentinel worker's own CUDA stream over
     40 batches of 256 events: no disagreement, served logits bitwise
     equal to an engine without the sentinel, and ``sentinel_verify_s``
     of the post-hoc stream check over the stream's wall;
   * ``ServingLoop`` (``DeadlineBatcher`` + ``run_plan``): 512 requests
     of 1-300 events, every future within ``fused_full``'s tolerance of
     ``engine.infer``, in-flight plans at most 4, at least one B1 launch
     per plan; requests/s and completion p50 / p99; then a burst of six
     full buckets in one submit against ``max_inflight=2``: dispatch
     blocks on the oldest plan and the in-flight peak is exactly 2;
   * ``ServingEngine.roofline([256])`` of ``fused_full`` and
     ``jedi_linear_full`` at the H100's fp32 peak beside B1's and B2's
     measured times, printed only: the modeled times and the canary bar
     stay out of the kernels' JSON line, which holds measured numbers.

Before the last line it prints one JSON object with each kernel's
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import pathlib
import re
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

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

#: B4 and B5, kernel vs plain version on the card, in fp32 and with bf16
#: inputs alike: both read the same values (bf16 is upcast exactly) and
#: sum in fp32 in another order, so the reference's fp32 tolerance holds.
#: B4 is held against the scale before its identity's cancellation,
#: max_b sum_k (sum_f v)^2, or for whole FM logits against their largest
#: magnitude; B5 against max(1, max |out|).
TOL_FM_DECODE = 2e-4

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


def kernel_name(mangled: str) -> str:
    """A ptxas report's mangled kernel name, short: the identifier and its
    template arguments (``jedi_fused_full_warp_kernel<20,0>``)."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if m is None:
        return mangled
    n = int(m.group(1))
    ident, rest = mangled[m.end():m.end() + n], mangled[m.end() + n:]
    if not rest.startswith("I"):
        return ident
    args = ["bf16" if "bfloat16" in rest else "f32"] \
        if rest.startswith(("If", "I13")) else []
    args += re.findall(r"L[ib](\d+)E", rest)
    return f"{ident}<{','.join(args)}>"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


#: Windows of ``reps`` launches that ``time_ms`` times: the median of 5
#: keeps one stall of the shared host (a few ms, spread over a window of
#: 20-us launches) out of the number.
WINDOWS = 5


def time_ms(fn, reps: int, spread: list | None = None) -> float:
    """Time per call of ``fn()`` between CUDA events around ``reps``
    back-to-back calls (after a warm-up): the median of WINDOWS such
    windows, whose (min, max) is appended to ``spread`` when given."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    per_call = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(stop) / reps)
    if spread is not None:
        spread.append((min(per_call), max(per_call)))
    return sorted(per_call)[WINDOWS // 2]


def profiled_ms(fn, kernel: str, launches: int = 20) -> float | None:
    """Device time per launch of the kernels whose names hold ``kernel``,
    from ``torch.profiler``'s ``key_averages()`` over ``launches`` calls
    of ``fn`` (after one warm call); None when the trace holds no device
    time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key and ev.device_time_total > 0:
            total += ev.device_time_total
            count += ev.count
    return total / count / 1e3 if count else None


def graph_ms(fn, launches: int = 20, replays: int = 20) -> float:
    """Device time per launch of ``fn`` from a CUDA graph of ``launches``
    captured calls, replayed ``replays`` times between CUDA events: no
    host work between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                      # built, opted in, launch header cached
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * launches)


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


def fm_work(batch: int, f: int, k: int, elem: int) -> tuple[float, float]:
    """(operations, bytes) of the FM pairwise term at (batch, F, K): per
    value an add and a square-and-add (3), per k the square, the
    difference and the add over k (3), per sample the halving; v
    (``elem`` bytes a value) read once, the (B,) fp32 output written
    once."""
    ops = batch * (3 * f * k + 3 * k + 1)
    return ops, batch * f * k * elem + 4 * batch


def decode_work(b: int, s: int, h: int, hkv: int, d: int,
                elem: int) -> tuple[float, float]:
    """(operations, bytes) of one-token attention over a cache of S
    keys, all valid: per (query head, key) the score (2D), its weight on
    v (2D), and the mask's select, the max, the exp and the sum (4); the
    cache (``elem`` bytes a value), q, q_pos and kv_pos read once, the
    fp32 output written once."""
    ops = b * h * s * (4 * d + 4)
    nbytes = 2 * b * s * hkv * d * elem + 4 * (2 * b * h * d + b + b * s)
    return ops, nbytes


#: h2o-danube-1.8b (src/repro/configs/h2o_danube_1_8b.py: d_model 2560,
#: 32 heads, 8 kv heads, so D = 80 and G = 4) at the decode_32k shape of
#: the LM family (src/repro/configs/base.py LM_SHAPES: 128 sequences of
#: 32,768 tokens), with a bf16 cache.
DANUBE_DECODE = dict(b=128, s=32768, h=32, hkv=8, d=80)


@dataclasses.dataclass
class JediOps:
    """How phases 2 and 3 drive a JEDI-net kernel (B1, B2, B3)."""

    bind: Callable              # (params, cfg) -> bound weights
    run: Callable               # (x, bound, cfg, block_s) -> result
    plain: Callable             # (x, bound, cfg, block_s) -> result
    layout: Callable            # (cfg, params, block_s) -> Layout
    work: Callable              # (cfg, batch) -> (operations, bytes)


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel of the port, as this script drives it."""

    name: str
    source: str
    replaces: str
    lib: tuple                  # (library name, sources) for build.py
    counter: Callable           # the wrapper carrying .launches
    jedi: JediOps | None = None


@dataclasses.dataclass
class Timing:
    """A kernel's timing case at its main path's shape: the wrapper, its
    plain version and, where one PyTorch call computes the same
    function, that call, on the same inputs; the launches of the main
    path's run and the kernel's error against its plain version there."""

    label: str
    run: Callable[[], object]
    plain: Callable[[], object]
    ops: float
    nbytes: float
    max_abs_err: float
    launches: int
    reps: int = 200
    plain_reps: int = 20
    library: Callable[[], object] | None = None
    library_name: str = ""
    extra: dict = dataclasses.field(default_factory=dict)


def zero_counts(kernels) -> None:
    for k in kernels:
        k.counter.launches = 0


def check_fm_kernel(dev) -> None:
    """B4 against its plain version on unit-normal v, so the identity's
    cancellation cannot hide a wrong term, at TOL_FM_DECODE of the scale
    before it, max_b sum_k (sum_f v)^2."""
    from repro_torch.kernels.fm_interaction import kernel as FMK
    gen = torch.Generator(device=dev).manual_seed(4)
    for b, f, k in ((1, 39, 10), (7, 39, 10), (513, 39, 10),
                    (262_144, 39, 10), (13, 26, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            v = torch.randn((b, f, k), generator=gen, device=dev).to(dtype)
            out = FMK.fm_interaction_kernel_call(v)
            again = FMK.fm_interaction_kernel_call(v)
            torch.cuda.synchronize()
            ref = FMK.fm_interaction_ref(v)
            err = float((out - ref).abs().max())
            scale = float(v.float().sum(1).square().sum(-1).max())
            spb, smem = FMK.plan(f, k)
            check(out.shape == (b,) and bool(torch.isfinite(out).all())
                  and err <= TOL_FM_DECODE * scale
                  and torch.equal(out, again),
                  f"fm_interaction {str(dtype)[6:]} B={b} F={f} K={k}: "
                  f"max|err| {err:.3e} ({err / scale:.2e} of scale "
                  f"{scale:.1f}, tol {TOL_FM_DECODE:g}), repeat bitwise "
                  f"equal, {spb} samples per block, {smem} B shared memory")


def decode_inputs(gen, dev, b, h, hkv, d, s, dtype, *, causal=True,
                  q_pos=None):
    """Unit-normal q (B, H, D) fp32 and cache (B, S, Hkv, D) in ``dtype``;
    q_pos random in [1, S) unless given; kv_pos the slot positions, -1
    past q_pos when ``causal``."""
    q = torch.randn((b, h, d), generator=gen, device=dev)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev, dtype=dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev, dtype=dtype)
    if q_pos is None:
        q_pos = torch.randint(1, s, (b,), generator=gen, device=dev,
                              dtype=torch.int32)
    else:
        q_pos = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    kv_pos = torch.arange(s, dtype=torch.int32, device=dev).repeat(b, 1)
    if causal:
        kv_pos = torch.where(kv_pos <= q_pos[:, None], kv_pos, -1)
    return q, k, v, q_pos, kv_pos.contiguous()


def scaled_groups(q, hkv: int):
    """q (B, H, D) scaled by 1/sqrt(D) in fp32 as (B, Hkv, G, D), the
    kernel's input (what ``ops.flash_decode`` hands it)."""
    b, h, d = q.shape
    return (q.float() * (1.0 / d ** 0.5)).reshape(b, hkv, h // hkv, d)


def check_decode_kernel(dev) -> None:
    """B5 against its plain version at TOL_FM_DECODE of max(1, |out|)."""
    from repro_torch.kernels.flash_decode import kernel as FDK
    from repro_torch.kernels.flash_decode import ops as fd_ops
    gen = torch.Generator(device=dev).manual_seed(6)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = (  # label, (B, H, Hkv, D, S), chunk, window, dtype, q_pos
        ("MHA G=1", (2, 4, 4, 32, 256), 64, None, f32, None),
        ("GQA G=4", (4, 8, 2, 64, 512), 128, None, f32, None),
        ("MQA G=16", (1, 16, 1, 128, 1024), 256, None, f32, None),
        ("D=80 G=4", (2, 32, 8, 80, 1024), None, None, f32, None),
        ("window 64, first chunks all masked", (2, 4, 2, 32, 256), 64, 64,
         f32, [200, 255]),
        ("bf16 cache D=80 G=4", (2, 32, 8, 80, 1024), None, None, bf16,
         None),
        ("bf16 cache S=1000, tile 64", (2, 32, 8, 80, 1000), 64, None, bf16,
         None),
        ("row 0 with no valid key", (3, 8, 2, 80, 200), 64, None, f32, None),
        ("bf16 D=33 (plain staging)", (2, 8, 2, 33, 100), 16, None, bf16,
         None),
        ("danube decode_32k B=1", (1, 32, 8, 80, 32768), None, None, bf16,
         None),
        ("danube decode_32k B=2", (2, 32, 8, 80, 32768), None, None, bf16,
         None),
        ("row 0 with no valid key, many partitions", (2, 32, 8, 80, 32768),
         None, None, bf16, None),
    )
    for label, (b, h, hkv, d, s), chunk, window, dtype, qp in cases:
        q, k, v, q_pos, kv_pos = decode_inputs(
            gen, dev, b, h, hkv, d, s, dtype, causal=window is None,
            q_pos=qp)
        masked = label.startswith("row 0")
        if masked:
            kv_pos[0] = -1
        out = fd_ops.flash_decode(q, k, v, q_pos, kv_pos, chunk=chunk,
                                  window=window)
        again = fd_ops.flash_decode(q, k, v, q_pos, kv_pos, chunk=chunk,
                                    window=window)
        torch.cuda.synchronize()
        ref = FDK.flash_decode_ref(scaled_groups(q, hkv), k, v, q_pos,
                                   kv_pos, window=window).reshape(b, h, d)
        err, rel = err_of(out, ref)
        ok = out.shape == (b, h, d) and bool(torch.isfinite(out).all()) \
            and rel <= TOL_FM_DECODE and torch.equal(out, again)
        if masked:
            # the reference's finite NEG_INF: the mean of v, not 0 or NaN
            mean_v = v[0].float().mean(0).repeat_interleave(h // hkv, 0)
            ok = ok and float((out[0] - mean_v).abs().max()) <= 1e-5
        lay = FDK.plan(b, hkv, h // hkv, d, s, k.element_size(), chunk)
        check(ok, f"flash_decode {label} (B={b} H={h} Hkv={hkv} D={d} S={s} "
                  f"{str(dtype)[6:]}): max|err| {err:.3e} ({rel:.2e} of "
                  f"scale, tol {TOL_FM_DECODE:g}), repeat bitwise equal, "
                  f"{lay.n_parts} partitions of {lay.part_len} keys, "
                  f"{lay.stages}-stage ring, {lay.path} path, "
                  f"{lay.smem_bytes} B shared memory")
        del q, k, v, ref


def fm_path(dev, card: str, kernels, b4: Kernel) -> Timing:
    """FM scoring at the full ``fm`` width through B4 (phase 3); returns
    B4's timing case at serve_bulk."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.recsys_data import ctr_batches
    from repro_torch.kernels.fm_interaction import kernel as FMK
    from repro_torch.models import recsys

    spec = get_arch("fm")
    cfg = spec.model
    t0 = time.perf_counter()
    params = recsys.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    table = params["tables"]["rows"]
    t_init = time.perf_counter() - t0
    want_std = 0.01 / cfg.embed_dim ** 0.5
    std = float(table[:1_000_000].float().std())
    check(table.is_cuda and table.shape == (recsys.padded_rows(cfg),
                                            cfg.embed_dim)
          and abs(std - want_std) < 0.01 * want_std,
          f"fm init on the card: {table.shape[0]:,} rows x {cfg.embed_dim} "
          f"{table.dtype} ({table.numel() * table.element_size() / 2**30:.2f}"
          f" GiB) in {t_init:.2f} s; std of 1M rows {std:.4e} (reference "
          f"{want_std:.4e})")
    ids = {}
    for seed, shape in enumerate(("serve_p99", "serve_bulk")):
        batch = spec.shapes[shape].dim("batch")
        ids[shape] = torch.from_numpy(
            next(ctr_batches(seed, batch, cfg.vocab_sizes))["ids"]).to(dev)

    # the main path: one B4 launch per forward call
    calls = {"serve_p99": 8, "serve_bulk": 4}
    zero_counts(kernels)
    for shape, n in calls.items():
        for _ in range(n):
            out = recsys.forward(params, cfg, ids[shape], use_kernel=True)
    torch.cuda.synchronize()
    launches = b4.counter.launches
    others = {k.name: k.counter.launches for k in kernels
              if k is not b4 and k.counter.launches}
    check(launches == sum(calls.values()) and not others
          and bool(torch.isfinite(out).all()),
          f"fm forward(use_kernel=True): {launches} fm_interaction launches "
          f"for {sum(calls.values())} calls, other kernels {others or 'none'}")

    # kernel vs plain end to end, then the retrieval identity, with the
    # init table and with unit-normal rows
    rng = np.random.RandomState(2)
    user = ids["serve_p99"][0, :-1]
    n_cand = spec.shapes["retrieval_cand"].dim("n_candidates")
    cands = torch.from_numpy(rng.randint(0, cfg.vocab_sizes[-1], n_cand)
                             .astype(np.int32)).to(dev)
    pick = torch.from_numpy(np.sort(rng.choice(n_cand, 1024, replace=False))
                            ).to(dev)
    v_bulk = recsys.lookup(params, cfg, ids["serve_bulk"])[0]
    err_bulk = float((FMK.fm_interaction_kernel_call(v_bulk)
                      - FMK.fm_interaction_ref(v_bulk)).abs().max())
    gen = torch.Generator(device=dev).manual_seed(3)
    metrics = {}
    for rows in ("init table", "unit-normal rows"):
        if rows == "unit-normal rows":
            table.normal_(generator=gen)
        for shape, x in ids.items():
            got = recsys.forward(params, cfg, x, use_kernel=True)
            want = recsys.forward(params, cfg, x, use_kernel=False)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(got.shape == (x.shape[0],) and bool(torch.isfinite(got).all())
                  and err <= TOL_FM_DECODE * scale,
                  f"fm {rows} {shape} B={x.shape[0]}: forward(use_kernel="
                  f"True) vs plain max|err| {err:.3e} ({err / scale:.2e} of "
                  f"max |logit| {scale:.3e}, tol {TOL_FM_DECODE:g})")
        scores = recsys.retrieval_score(params, cfg, user, cands)
        full = torch.cat([user.expand(len(pick), -1), cands[pick, None]], 1)
        fwd = recsys.forward(params, cfg, full, use_kernel=True)
        err = float((scores[pick] - fwd).abs().max())
        scale = float(fwd.abs().max())
        check(scores.shape == (n_cand,) and bool(torch.isfinite(scores).all())
              and err <= TOL_FM_DECODE * scale,
              f"fm {rows} retrieval_cand 1 x {n_cand:,}: retrieval_score vs "
              f"forward on [u || c] at 1024 candidates max|err| {err:.3e} "
              f"({err / scale:.2e} of {scale:.3e}, tol {TOL_FM_DECODE:g})")

    # end-to-end times of the path on the card (ids already there)
    for shape, x in ids.items():
        reps = 50 if shape == "serve_p99" else 10
        ms = time_ms(lambda: recsys.forward(params, cfg, x, use_kernel=True),
                     reps)
        plain = time_ms(lambda: recsys.forward(params, cfg, x), reps)
        metrics[shape] = {"batch": x.shape[0], "ms": ms,
                          "samples_per_s": x.shape[0] / ms * 1e3,
                          "plain_forward_ms": plain}
        print(f"  fm forward(use_kernel=True) {shape} B={x.shape[0]}: {ms:.4f}"
              f" ms/batch, {x.shape[0] / ms * 1e3:,.0f} samples/s "
              f"(forward with the plain term {plain:.4f} ms)  [{card}]")
    ms = time_ms(lambda: recsys.retrieval_score(params, cfg, user, cands), 20)
    metrics["retrieval_cand_ms"] = ms
    print(f"  fm retrieval_score 1 x {n_cand:,}: {ms:.4f} ms, "
          f"{n_cand / ms * 1e3:,.0f} candidates/s  [{card}]")
    del params, table
    ops_, nbytes = fm_work(*v_bulk.shape, v_bulk.element_size())
    return Timing(
        f"fm serve_bulk B={v_bulk.shape[0]} F={v_bulk.shape[1]} "
        f"K={v_bulk.shape[2]} fp32",
        lambda: FMK.fm_interaction_kernel_call(v_bulk),
        lambda: FMK.fm_interaction_ref(v_bulk), ops_, nbytes, err_bulk,
        launches, extra={"main_path": "models.recsys.forward(use_kernel="
                         "True)", "fm": metrics})


def decode_path(dev, card: str, kernels, b5: Kernel) -> Timing:
    """flash_decode at h2o-danube-1.8b's decode_32k shape (phase 3): a few
    decode steps through the public op; returns B5's timing case."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import kernel as FDK
    from repro_torch.kernels.flash_decode import ops as fd_ops

    b, s, h, hkv, d = (DANUBE_DECODE[n] for n in ("b", "s", "h", "hkv", "d"))
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, _, kv_pos = decode_inputs(gen, dev, b, h, hkv, d, s,
                                       torch.bfloat16, causal=False,
                                       q_pos=[0] * b)
    steps = 4
    zero_counts(kernels)
    for i in range(steps):
        # step i sees the cache up to position S - steps + i
        q_pos = torch.full((b,), s - steps + i, dtype=torch.int32, device=dev)
        out = fd_ops.flash_decode(q, k, v, q_pos, kv_pos)
    torch.cuda.synchronize()
    launches = b5.counter.launches
    others = {kk.name: kk.counter.launches for kk in kernels
              if kk is not b5 and kk.counter.launches}
    qg = scaled_groups(q, hkv)
    ref = FDK.flash_decode_ref(qg, k, v, q_pos, kv_pos).reshape(b, h, d)
    err, rel = err_of(out, ref)
    check(launches == steps and not others and out.shape == (b, h, d)
          and bool(torch.isfinite(out).all()) and rel <= TOL_FM_DECODE,
          f"flash_decode h2o-danube-1.8b decode_32k B={b} S={s} H={h} "
          f"Hkv={hkv} D={d} bf16 cache: {launches} launches for {steps} "
          f"steps, other kernels {others or 'none'}; last step vs plain "
          f"max|err| {err:.3e} ({rel:.2e} of scale, tol {TOL_FM_DECODE:g})")
    del ref
    torch.cuda.empty_cache()
    # the library call: SDPA in bf16 on the transposed cache, same mask
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    qb = q.to(torch.bfloat16)[:, :, None, :]
    mask = ((kv_pos >= 0) & (kv_pos <= q_pos[:, None]))[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qb, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    sdpa_diff = float((sdpa()[:, :, 0].float() - out).abs().max())
    print(f"  scaled_dot_product_attention (bf16 q) vs the kernel: max "
          f"|diff| {sdpa_diff:.3e} (q rounded to bf16)")
    ops_, nbytes = decode_work(b, s, h, hkv, d, k.element_size())
    lay = FDK.plan(b, hkv, h // hkv, d, s, k.element_size())
    return Timing(
        f"h2o-danube-1.8b decode_32k B={b} S={s} H={h} Hkv={hkv} D={d} bf16",
        lambda: FDK.flash_decode_kernel_call(qg, k, v, q_pos, kv_pos),
        lambda: FDK.flash_decode_ref(qg, k, v, q_pos, kv_pos), ops_, nbytes,
        err, launches, reps=10, plain_reps=3, library=sdpa,
        library_name="scaled_dot_product_attention (bf16, enable_gqa, "
                     "boolean mask)",
        extra={"main_path": "kernels.flash_decode.ops.flash_decode",
               "sdpa_max_abs_diff": sdpa_diff, "partitions": lay.n_parts,
               "partition_keys": lay.part_len, "stages": lay.stages,
               "path": lay.path, "blocks": lay.blocks,
               "warps_per_block": lay.heads})


#: The serving front's settings: EXPERIMENTS.md §Sentinel's drill
#: (canary_every=3, promote_after=2, one-shot faults, sync shadows at the
#: reference test's 1/4), and one engine per (path, seam).
SILENT_DRILL = (("int8_fused_full", "scale_drift", 8.0),
                ("fused_full", "weight_corrupt", 8.0),
                ("fused_full", "stale_cache", 1.0),
                ("jedi_linear_full", "weight_corrupt", 8.0))
LOUD_COUNTERS = ("compile_failures", "dispatch_failures",
                 "nonfinite_batches", "watchdog_timeouts")


def serving_front(dev, card: str, kernels, b1: Kernel, b2: Kernel,
                  rows: list) -> dict:
    """Phase 5: the silent-seam drill, async shadows, ``ServingLoop`` and
    the roofline, at jedi_30p full width fp32 through ``ResilientEngine``.
    Returns each kernel's launches over the phase's runs; every run is
    driven with the counts set to 0 just before it and read just after."""
    import threading

    from repro_torch.configs import jedi_30p
    from repro_torch.core import interaction_net as inet
    from repro_torch.core import paths
    from repro_torch.data.jets import make_jets
    from repro_torch.serving import (FaultInjector, ResilientEngine,
                                     SentinelConfig, ServingEngine,
                                     ServingLoop)

    cfg, batch = jedi_30p.MODEL, 256
    params = inet.init(0, cfg, scale="lecun", device=dev)
    launches = {k.name: 0 for k in kernels}

    def counted(run):
        zero_counts(kernels)
        out = run()
        torch.cuda.synchronize()
        for k in kernels:
            launches[k.name] += k.counter.launches
        return out

    def loud(counters) -> dict:
        return {k: counters[k] for k in LOUD_COUNTERS if k in counters}

    # -- 1. the silent-seam drill, one engine per row ---------------------
    print("== 5. serving front: silent-seam drill (sentinel)")
    drill = {}
    rng = np.random.RandomState(0)
    for path, seam, factor in SILENT_DRILL:
        wrapper = b2 if path.startswith("jedi_linear") else b1
        inj = FaultInjector()
        inj.arm(seam, path=path, times=1, factor=factor)
        xs = [make_jets(rng, batch, cfg.n_objects)[0] for _ in range(12)]

        def run():
            eng = ResilientEngine(
                params, cfg, forward=path, device=dev, max_batch=batch,
                injector=inj, sentinel=SentinelConfig(
                    canary_every=3, promote_after=2, shadow_rate=0.25,
                    shadow_sync=True))
            states, finite = [], True
            for x in xs:
                finite &= bool(np.isfinite(eng.infer(x)).all())
                states.append(eng.health()["state"])
            return eng, states, finite

        before = launches[wrapper.name]
        try:
            eng, states, finite = counted(run)
        except Exception as e:   # noqa: BLE001 — recorded as a failure
            check(False, f"drill {path} {seam}: raised {e!r}")
            continue
        h = eng.health()
        c = h["counters"]
        dev_key = f"canary_dev_b{eng.bucket_for(batch)}"
        detected = states.index("quarantined") + 1 \
            if "quarantined" in states else None
        requalified = states.index("healthy") + 1 \
            if "healthy" in states else None
        peak = eng.metrics.gauge_max(dev_key)
        last = eng.metrics.gauge_value(dev_key)
        bar = 8 * paths.get(path).tolerance
        drill[f"{path}/{seam}"] = {
            "detected_at": detected, "requalified_at": requalified,
            "peak_canary_dev": peak, "clean_canary_dev": last,
            "counters": c,
            "launches": launches[wrapper.name] - before}
        check(detected == 1 and requalified is not None
              and requalified <= 9 and finite and not loud(c)
              and h["state"] == "healthy" and inj.fired() == 1
              and c.get("quarantines") == 1
              and c.get("requalifications") == 1
              and launches[wrapper.name] > before,
              f"drill {path} {seam}: detected at batch {detected}, "
              f"requalified at batch {requalified}, peak canary_dev {peak:.4e}"
              f" (bar {bar:g}, clean canary_dev {last:.3e}), final state "
              f"{h['state']}, loud counters {loud(c) or 'none'}, "
              f"{launches[wrapper.name] - before} {wrapper.name} launches")

    # -- 2. async shadows on the worker's own stream ----------------------
    print("== 5. serving front: async shadows")
    stream = [make_jets(rng, batch, cfg.n_objects)[0] for _ in range(40)]
    plain = ResilientEngine(params, cfg, forward="fused_full", device=dev,
                            max_batch=batch)
    want = counted(lambda: [plain.infer(x) for x in stream])
    eng = ResilientEngine(params, cfg, forward="fused_full", device=dev,
                          max_batch=batch,
                          sentinel=SentinelConfig(shadow_rate=0.25,
                                                  shadow_sync=False))
    terminal = eng._engine_for(eng.sentinel.terminal_level)
    seen = []
    infer = terminal.infer

    def spy(x, **kw):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_stream(dev)))
        return infer(x, **kw)

    terminal.infer = spy

    def run():
        got = [eng.infer(x) for x in stream]
        eng.sentinel.drain()
        return got

    got = counted(run)
    terminal.infer = infer
    c = eng.metrics.counters
    worker = eng.sentinel.shadow_stream
    on_worker = bool(seen) and worker is not None \
        and worker != torch.cuda.default_stream(dev) \
        and all(n == "sentinel-shadow" and st == worker for n, st in seen)
    bitwise = all(np.array_equal(a, b) for a, b in zip(got, want))
    check(c.get("shadow_requests", 0) > 0
          and not c.get("shadow_disagreements") and on_worker and bitwise
          and not loud(c) and eng.health()["state"] == "healthy",
          f"async shadows fused_full: {c.get('shadow_requests', 0)} shadow "
          f"requests, {c.get('shadow_disagreements', 0)} disagreements, "
          f"{len(seen)} shadow serves all on the worker's own stream: "
          f"{on_worker}; 40 served batches bitwise equal to no sentinel: "
          f"{bitwise}; shadow_dev_ewma "
          f"{eng.metrics.gauge_value('shadow_dev_ewma_b256'):.3e}")
    res = counted(lambda: eng.run_stream(stream, warmup=2))
    eng.sentinel.close()
    verify_s = eng.metrics.gauge_value("sentinel_verify_s")
    shadows = {"shadow_requests": c.get("shadow_requests", 0),
               "on_worker_stream": on_worker, "bitwise_equal": bitwise,
               "stream_wall_s": res["wall_s"], "sentinel_verify_s": verify_s,
               "verify_share": verify_s / res["wall_s"]}
    print(f"  sentinel_verify_s {verify_s * 1e3:.3f} ms over the stream's "
          f"wall {res['wall_s'] * 1e3:.3f} ms ({verify_s / res['wall_s']:.1%}"
          f"; {len(stream)} batches of {batch}, canary_every 64, shadow 1/4)"
          f"  [{card}]")

    # -- 3. ServingLoop: DeadlineBatcher + run_plan through B1 ------------
    print("== 5. serving front: ServingLoop")
    sizes = np.random.RandomState(0).randint(1, 301, size=512)
    events = make_jets(rng, int(sizes.sum()), cfg.n_objects)[0]
    reqs = np.split(events, np.cumsum(sizes)[:-1])
    eng = ResilientEngine(params, cfg, forward="fused_full", device=dev,
                          max_batch=batch)
    eng.warm([batch])
    loop = ServingLoop(eng, deadline_s=2e-3, max_inflight=4)
    t_submit, t_done = {}, {}

    def run():
        pending = []

        def reap():
            now = time.perf_counter()
            for f in [f for f in pending if f.done]:
                t_done[f.rid] = now
                pending.remove(f)

        t0 = time.perf_counter()
        futs = []
        for x in reqs:
            t_submit[len(futs)] = time.perf_counter()
            fut = loop.submit(x)
            futs.append(fut)
            pending.append(fut)
            loop.poll()
            reap()
        loop.drain()
        reap()
        return futs, time.perf_counter() - t0

    futs, wall = counted(run)
    plans = eng.metrics.counter("loop_plans")
    b1_launches = b1.counter.launches
    complete = all(f.done and not f.shed for f in futs)
    gap = max(float(np.abs(f.result() - eng.infer(x)).max())
              for f, x in zip(futs, reqs)) if complete else float("inf")
    tol = paths.get("fused_full").tolerance
    lat = sorted((t_done[i] - t_submit[i]) * 1e6 for i in t_done)
    inflight = eng.metrics.gauge_max("inflight_plans")
    c = eng.metrics.counters
    check(complete and len(lat) == len(reqs) and gap <= tol
          and inflight <= 4 and b1_launches >= plans and not loud(c)
          and "shed_requests" not in c,
          f"ServingLoop fused_full: {len(reqs)} requests of 1-300 events "
          f"({int(sizes.sum())} events) in {plans} plans, all complete: "
          f"{complete}; max |future - engine.infer| {gap:.3e} (tol {tol:g});"
          f" inflight_plans peak {inflight:g} <= 4; {b1_launches} "
          f"{b1.name} launches >= {plans} plans")
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    loop_rec = {"requests": len(reqs), "events": int(sizes.sum()),
                "plans": plans, "wall_s": wall,
                "requests_per_s": len(reqs) / wall,
                "events_per_s": int(sizes.sum()) / wall,
                "completion_p50_us": p50, "completion_p99_us": p99,
                "max_abs_gap": gap, "inflight_plans_max": inflight,
                "queue_depth_max": eng.metrics.gauge_max("queue_depth")}
    print(f"  ServingLoop: {len(reqs) / wall:,.0f} requests/s, "
          f"{int(sizes.sum()) / wall / 1e3:,.1f} K events/s; completion "
          f"p50 {p50:.1f} us p99 {p99:.1f} us (deadline 2 ms, "
          f"max_inflight 4, queue depth peak "
          f"{loop_rec['queue_depth_max']:g})  [{card}]")

    # a burst: one request of six full buckets, cut and dispatched in one
    # submit against a cap of 2, so dispatch must block on the oldest plan
    eng = ResilientEngine(params, cfg, forward="fused_full", device=dev,
                          max_batch=batch)
    eng.warm([batch])
    burst = ServingLoop(eng, deadline_s=2e-3, max_inflight=2)
    x = make_jets(rng, 6 * batch, cfg.n_objects)[0]
    realized, realize = [], burst._realize

    def spy(entry):
        realized.append((entry[0], burst.inflight))
        realize(entry)

    burst._realize = spy

    def run():
        fut = burst.submit(x)
        burst.drain()
        return fut

    fut = counted(run)
    bp = realized[:4]
    peak = eng.metrics.gauge_max("inflight_plans")
    plans = eng.metrics.counter("loop_plans")
    gap = float(np.abs(fut.result() - eng.infer(x)).max()) \
        if fut.done and not fut.shed else float("inf")
    check(plans == 6 and bp == [(0, 2), (1, 2), (2, 2), (3, 2)]
          and peak == 2 and gap <= tol and b1.counter.launches >= plans,
          f"ServingLoop burst: {plans} plans in one submit at max_inflight "
          f"2; dispatch blocked on plans (seq, in flight) {bp} "
          f"(want the oldest first at the cap); inflight_plans peak "
          f"{peak:g} == 2; max |future - engine.infer| {gap:.3e}")
    loop_rec["burst"] = {"plans": plans, "inflight_plans_max": peak,
                         "blocked_on": [q for q, _ in bp],
                         "max_abs_gap": gap}

    # -- 4. the H100 roofline beside the measured device time -------------
    print("== 5. serving front: roofline (fp32, H100 datasheet peaks)")
    roof = {}
    for i, (path, k) in enumerate((("fused_full", b1),
                                   ("jedi_linear_full", b2))):
        m = ServingEngine(params, cfg, forward=path, device=dev,
                          max_batch=batch).roofline([batch])[batch]
        roof[path] = m
        print(f"  {path} bucket {batch}: modeled {m['step_us']:.2f} us/step "
              f"({m['bound']}-bound, {m['flops'] / 1e9:.4f} GFLOP at "
              f"{m['peak_flops'] / 1e12:g} TFLOP/s, {m['hbm_bytes'] / 1e6:.3f}"
              f" MB at 3.35 TB/s, level={m['fused_level']}); {k.name} "
              f"measured {rows[i]['ms'] * 1e3:.2f} us eager, "
              f"{rows[i]['device_ms_graph'] * 1e3:.2f} us device (CUDA graph)"
              f"  [{card}]")
    for path, m in roof.items():
        check(np.isfinite(m["step_us"]) and m["step_us"] > 0
              and m["peak_flops"] == 67e12,
              f"roofline {path}: {m['step_us']:.3f} us at the fp32 peak")
    return {"launches": launches, "drill": drill, "async_shadows": shadows,
            "loop": loop_rec}


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
        from repro_torch.kernels.flash_decode import kernel as FDK
        from repro_torch.kernels.fm_interaction import kernel as FMK
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
        from repro_torch.core.codesign import H100_FP32_FLOPS as \
            PEAK_FP32_FLOPS, H100_HBM_BPS as PEAK_HBM_BYTES
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
        (FK.LIB_NAME, FK.SOURCES), FK.fused_forward_full_kernel_call,
        JediOps(
            ops.bind_full,
            lambda x, b, cfg, bs: FK.fused_forward_full_kernel_call(
                x, b, activation=cfg.activation, n_targets=cfg.n_targets,
                block_s=bs),
            lambda x, b, cfg, bs: FK.fused_forward_full_plain(
                x, b.fr, b.fo, b.phi, activation=cfg.activation,
                scales=b.scales, block_s=bs),
            lambda cfg, p, bs: fj_tune.full_layout_for(cfg, p, block_s=bs),
            fused_full_work))
    b2 = Kernel(
        "jedi_linear_full", csrc + "jedi_linear_full.cu",
        "src/repro/kernels/jedi_linear/linear_kernel.py:46",
        (LK.LIB_NAME, LK.SOURCES), LK.jedi_linear_kernel_call,
        JediOps(
            jl_ops.bind_linear,
            lambda x, b, cfg, bs: LK.jedi_linear_kernel_call(
                x, b, activation=cfg.activation, n_targets=cfg.n_targets),
            lambda x, b, cfg, bs: LK.jedi_linear_forward_full_plain(
                x, b.fr, b.fo, b.phi, activation=cfg.activation,
                scales=b.scales),
            lambda cfg, p, bs: jl_tune.layout_for(cfg, p),
            linear_work))
    b3 = Kernel(
        "fused_jedinet_edge", csrc + "fused_jedinet_edge.cu",
        "src/repro/kernels/fused_jedinet/kernel.py:64",
        (EK.LIB_NAME, EK.SOURCES), EK.fused_edge_block_kernel_call,
        JediOps(
            lambda p, cfg: ops.bind_edge(p["fr"], cfg),
            lambda x, b, cfg, bs: EK.fused_edge_block_kernel_call(
                x, b, activation=cfg.activation, block_s=bs),
            lambda x, b, cfg, bs: EK.fused_edge_block_plain(
                x, b.fr, activation=cfg.activation, block_s=bs),
            lambda cfg, p, bs: fj_tune.edge_layout_for(cfg, p, block_s=bs),
            edge_work))
    b4 = Kernel(
        "fm_interaction", csrc + "fm_interaction.cu",
        "src/repro/kernels/fm_interaction/kernel.py:21",
        (FMK.LIB_NAME, FMK.SOURCES), FMK.fm_interaction_kernel_call)
    b5 = Kernel(
        "flash_decode", csrc + "flash_decode.cu",
        "src/repro/kernels/flash_decode/kernel.py:35",
        (FDK.LIB_NAME, FDK.SOURCES), FDK.flash_decode_kernel_call)
    kernels = [b1, b2, b3, b4, b5]

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
    spills = {}
    for k in kernels:
        fn = ""
        for line in build.build_log(*k.lib).splitlines():
            if "Function properties for" in line:
                fn = kernel_name(line.split()[-1])
            if "registers" in line or "spill" in line:
                print(f"  {k.name} {fn}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spills[fn] = int(m.group(1)) + int(m.group(2))
    # the register-resident designs at jedi_30p (RW 20, one sender tile)
    # and jedi_50p (RW 64, two tiles), and B2's rows design (one kernel per
    # activation)
    rows = sorted(fn for fn in spills
                  if fn.startswith("jedi_linear_rows_kernel<"))
    check(len(rows) == len(ACTIVATIONS),
          f"jedi_linear_rows_kernel: {len(rows)} instances built, one per "
          f"activation ({len(ACTIVATIONS)})")
    for fn in ("jedi_fused_full_warp_kernel<20,0>",
               "jedi_fused_full_warp_kernel<64,1>",
               "jedi_edge_block_warp_kernel<20,0>",
               "jedi_edge_block_warp_kernel<64,1>", *rows):
        check(spills.get(fn) == 0,
              f"{fn}: {spills.get(fn, 'no report of')} bytes of spills")

    # ---- 2. kernels against their plain versions ------------------------
    print("== 2. kernels vs plain versions on the card")
    designs = {k.name: {} for k in (b1, b2, b3)}

    def case(k, label, cfg, batch, *, quant=False, block_s=None,
             tol=TOL_FP32):
        j = k.jedi
        params = inet.init(0, cfg, scale="lecun", device=dev)
        if quant:
            params = quantize_params_int8(params)
        x = torch.from_numpy(
            make_jets(np.random.RandomState(1), batch, cfg.n_objects)[0])
        bound = j.bind(params, cfg)
        cdt = getattr(torch, cfg.compute_dtype)
        xk = x.to(dev).to(cdt).contiguous()
        out = j.run(xk, bound, cfg, block_s)
        again = j.run(xk, bound, cfg, block_s)
        torch.cuda.synchronize()
        ref = j.plain(xk, bound, cfg, block_s)
        err, rel = err_of(out, ref)
        lay = j.layout(cfg, params, block_s)
        design = lay.design
        designs[k.name][f"{label} B={batch}"] = design
        check(out.shape == ref.shape and out.shape[0] == batch
              and bool(torch.isfinite(out).all()) and rel <= tol
              and torch.equal(out, again),
              f"{k.name} {label} B={batch}: max|err| {err:.3e} ({rel:.2e} "
              f"of scale, tol {tol:g}), repeat bitwise equal, {design} "
              f"layout epb={lay.events_per_block} S={lay.block_s} ks="
              f"{lay.ks} team={lay.team} mw={lay.mw} threads={lay.threads} "
              f"smem={lay.smem_bytes}")
        return err, (xk, bound, cfg)

    def bf16_rounds(k, args):
        """The bf16 rounding itself is held: the same bf16 x and weights,
        run in fp32 all through by the kernel and by the plain version,
        must land further than TOL_BF16 from the bf16 kernel."""
        j = k.jedi
        xb, bb, cfg = args
        b32 = FK.KernelWeights(
            fr=[t.float() for t in bb.fr], fo=[t.float() for t in bb.fo],
            phi=[t.float() for t in bb.phi], scales=None,
            n_features=bb.n_features).pack()
        kb = j.run(xb, bb, cfg, None)
        k32 = j.run(xb.float(), b32, cfg, None)
        unrounded = j.plain(xb.float(), b32, cfg, None)
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
    for b in (13, 257):
        case(b2, "jedi_50p fp32", c50, b)
    case(b2, "jedi_tracks_128 fp32", c128, 13)
    for b in (1, 13, 257):
        case(b3, "jedi_30p fp32", c30, b)
    main_err[b3.name], main_args[b3.name] = case(b3, "jedi_30p fp32", c30,
                                                 256)
    bf16_rounds(b3, case(b3, "jedi_30p bf16", bf30, 257, tol=TOL_BF16)[1])
    case(b3, f"jedi_30p fp32 S={c30.n_objects}", c30, 257,
         block_s=c30.n_objects)
    for b in (13, 257):
        case(b3, "jedi_50p fp32", c50, b)
    case(b3, "jedi_tracks_128 fp32", c128, 13)
    check_fm_kernel(dev)
    check_decode_kernel(dev)

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
        zero_counts(kernels)
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
        check(bucket == batch,
              f"{label}: {batch}-event batches served in bucket {bucket}")
        check(launches == n_batches + n_infer,
              f"{label}: {k.name} launches {launches} == served batches "
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
    timings = {}
    for k in (b1, b2, b3):
        xk, bound, cfg = main_args[k.name]
        ops_, nbytes = k.jedi.work(cfg, xk.shape[0])
        launches, snap = serving[main_path[k.name]]
        timings[k.name] = Timing(
            f"jedi_30p B={xk.shape[0]} fp32",
            functools.partial(k.jedi.run, xk, bound, cfg, None),
            functools.partial(k.jedi.plain, xk, bound, cfg, None), ops_,
            nbytes, main_err[k.name], launches,
            extra={"main_path": main_path[k.name],
                   "serving": {"kgps": snap["kgps"], "p50_us": snap["p50_us"],
                               "p99_us": snap["p99_us"]}})
    print("== 3. main paths: FM scoring at the full fm width")
    timings[b4.name] = fm_path(dev, card, kernels, b4)
    torch.cuda.empty_cache()
    print("== 3. main paths: flash decode at h2o-danube-1.8b decode_32k")
    timings[b5.name] = decode_path(dev, card, kernels, b5)

    # ---- 4. timing ----------------------------------------------------------
    print("== 4. kernel timing (CUDA events)")
    rows = []
    for k in kernels:
        t = timings[k.name]
        windows = []
        ms = time_ms(t.run, t.reps, windows)
        plain_ms = time_ms(t.plain, t.plain_reps)
        library_ms = time_ms(t.library, t.reps) if t.library else None
        t_ops = t.ops / PEAK_FP32_FLOPS * 1e3
        t_bytes = t.nbytes / PEAK_HBM_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        lib = (f"; {t.library_name} {library_ms:.4f} ms" if t.library else
               "; no single PyTorch call computes this function")
        print(f"  {k.name} at {t.label}: {ms:.4f} ms (windows "
              f"{windows[0][0]:.4f}-{windows[0][1]:.4f}; plain version "
              f"{plain_ms:.4f} ms{lib}); bound {bound_ms:.4f} ms "
              f"({t.ops / 1e9:.4f} GFLOP at 67 TFLOP/s fp32 vs "
              f"{t.nbytes / 1e6:.3f} MB at 3.35 TB/s)  [{card}]")
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": t.launches,
            "max_abs_err": t.max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "ms_windows": windows[0],
            "at": t.label, **t.extra,
            "card": card})
    # B1's and B3's first design (the team layout, which a pinned sender
    # tile selects) on the same inputs, for the record beside the new one
    for i, k in ((0, b1), (2, b3)):
        xk, bound, cfg = main_args[k.name]
        team_ms = time_ms(
            lambda: k.jedi.run(xk, bound, cfg, cfg.n_objects), 200)
        rows[i]["team_design_ms"] = team_ms
        print(f"  {k.name} team design (block_s={cfg.n_objects}) at "
              f"{timings[k.name].label}: {team_ms:.4f} ms  [{card}]")
    # the device time per launch of B1-B3, where a loop of eager launches
    # can measure the host's enqueue instead
    for i, k, kernel in ((0, b1, "jedi_fused_full"), (1, b2, "jedi_linear"),
                         (2, b3, "jedi_edge_block")):
        t = timings[k.name]
        prof = profiled_ms(t.run, kernel)
        graph = graph_ms(t.run)
        rows[i]["design"] = designs[k.name]["jedi_30p fp32 B=256"]
        rows[i]["device_ms_profiler"] = prof
        rows[i]["device_ms_graph"] = graph
        shown = "no device time" if prof is None else f"{prof:.4f} ms"
        print(f"  {k.name} device time per launch at {t.label}: "
              f"torch.profiler {shown}, CUDA graph of 20 launches "
              f"{graph:.4f} ms (eager loop {rows[i]['ms']:.4f} ms)  [{card}]")
    t5 = timings[b5.name].extra
    print(f"  flash_decode plan at {timings[b5.name].label}: "
          f"{t5['partitions']} partitions of {t5['partition_keys']} keys, "
          f"{t5['blocks']} blocks of {t5['warps_per_block']} warp(s), "
          f"{t5['stages']}-stage ring, "
          f"{t5['path']} path")
    for i, k in enumerate((b1, b2, b3)):
        for label, design in designs[k.name].items():
            print(f"  {k.name} design at {label}: {design}")
        rows[i]["designs"] = designs[k.name]
    # B2 at its widest shape, for the record beside its bound
    params = inet.init(0, c128, scale="lecun", device=dev)
    x = torch.from_numpy(make_jets(np.random.RandomState(1), batch,
                                   c128.n_objects)[0]).to(dev)
    bound = b2.jedi.bind(params, c128)
    ms128 = time_ms(lambda: b2.jedi.run(x, bound, c128, None), 50)
    ops_, nbytes = linear_work(c128, batch)
    bound128 = max(ops_ / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    print(f"  jedi_linear_full at jedi_tracks_128 B={batch} fp32: "
          f"{ms128:.4f} ms/batch; bound {bound128:.4f} ms ({ops_ / 1e9:.4f} "
          f"GFLOP)  [{card}]")
    rows[1]["tracks_128"] = {"ms": ms128, "bound_ms": bound128}
    for key, (launches, snap) in serving.items():
        print(f"  served {key}: {launches} launches, {snap['kgps']:.1f} KGPS")

    # ---- 5. the serving front ---------------------------------------------
    front = serving_front(dev, card, kernels, b1, b2, rows)
    for i, k in ((0, b1), (1, b2)):
        rows[i]["launches_by_phase"] = {
            "main_paths": rows[i]["launches"],
            "serving_front": front["launches"][k.name]}
        rows[i]["launches"] += front["launches"][k.name]
    rows[0]["serving_front"] = {kk: v for kk, v in front.items()
                                if kk != "launches"}
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB  [{card}]")

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
