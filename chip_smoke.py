"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only, on one CUDA card, and exits
non-zero on any failure:

1. the card (``nvidia-smi`` name and power limit), the torch, CUDA and
   ``nvcc`` versions, and the five kernels' build from the sources in the
   checkout (one ``nvcc`` per source, all started together), with each
   kernel's registers and spills (read by ``repro_torch.analysis.
   kernel_audit``'s ptxas parser), and no spills in the register-resident
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
     sequence partitions combine, and the bf16 shapes phases 7 and 8
     add: minicpm-2b's MHA (G=1, D=64; B=16, S=1,024), the serve CLI's
     (B=4, S=128) and moonshot-v1-16b-a3b's MHA (G=1, D=128; B=16,
     S=2,048);
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
   stages and path; B5 also at the LM paths' own decode shapes beside
   SDPA, with the plan each picks: danube's (B=128, T=4,096, bf16,
   window 4,096) and moonshot's (B=16, T=2,048, H=Hkv=16, D=128, bf16,
   full attention: the CUDA-core path), and at both the host's and
   the card's time a call through the op ``repro_torch::flash_decode``
   against its launch called straight (``dispatch_ab``, 12 interleaved
   pairs); B3 at its main shape against
   the unfused oracle ``kernels/fused_jedinet/ref.py`` (5e-4 of scale);
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
     equal to an engine without the sentinel, and the sentinel's cost as
     the wall of one ``run_stream`` of them with it over the wall
     without it;
   * ``ServingLoop`` (``DeadlineBatcher`` + ``run_plan``): 512 requests
     of 1-300 events, every future within ``fused_full``'s tolerance of
     ``engine.infer``, in-flight plans at most 4, at least one B1 launch
     per plan; requests/s and completion p50 / p99; then a burst of six
     full buckets in one submit against ``max_inflight=2``: dispatch
     blocks on the oldest plan and the in-flight peak is exactly 2;
   * ``ServingEngine.roofline([256])`` of ``fused_full`` and
     ``jedi_linear_full`` at the H100's fp32 peak beside B1's and B2's
     measured times, printed only: the modeled times and the canary bar
     stay out of the kernels' JSON line, which holds measured numbers;
6. training on the card, with TF32 off (no kernel of the port runs in
   a train step: forward and backward are plain PyTorch autograd, as the
   reference trains through XLA, and the check asserts no launch):
   * jedinet-30p at train_jets (B=4096), 300 AdamW steps at lr 2e-3
     through ``repro_torch.launch.train.main`` with async checkpoints,
     from the reference's initial weights at seed 0: ms per step of the
     loop (CUDA events) and it/s, the first and last loss (falling,
     finite) and the held-out accuracy on ``jet_batches(999)``'s 2048
     events, at least half of the reference's gain over chance (its CPU
     run at the same seed, steps and batch: 0.7803); then each layer of
     a step (host data, H2D, forward+backward, optimizer update, the step
     on a card batch, the checkpoint snapshot);
   * a crash injected at step 30 (``--fail-at-step``) and the rerun
     restoring step 25 and ending at the final checkpoint of step 60;
   * the final checkpoint restored (params bitwise equal to the trained
     ones) and served through B1: ``fused_full`` and
     ``int8_fused_full`` on the held-out events, 8 batches of 256 each,
     one launch per batch, no demotion, ``fused_full`` within 5e-4 of
     ``forward_sr`` on the card (scaled to at least 1) with the same
     argmax wherever the top two logits lie further apart than that;
     these launches join B1's main-path count (``launches_by_phase``);
   * ``fm`` at full width, ``train_batch`` (B=65,536), 16 AdamW steps at
     lr 1e-2 through the recsys program: ms per step, peak device memory
     above what was held before, the held-out loss below its ln 2 at
     init, and each layer of a step;
   * ``repro_torch.examples.codesign_search`` at its default 150 steps:
     J1-baseline, Opt-Latn and Opt-Acc with their FPGA-model latency and
     trained accuracy.

7. dense-LM serving at full width through ``LMEngine``, bf16 compute
   on fp32 params drawn on the card, the decode step's attention one B5
   launch per layer (each run with the launch counts set to 0 after its
   warm-up and read after it; its launches join B5's count by run):
   * 7a, h2o-danube-1.8b (24 layers, d_model 2560, 32 / 8 heads, D=80,
     window 4,096) with 128 slots and a 4,096-slot cache: 192 requests
     of 64-2,048 prompt tokens and 32 new tokens each; all complete,
     none shed, one prefill build per rung, B5 launches = 24 x decode
     steps, finite logits; prefill ms per rung, decode ms per step p50 /
     p99, tokens/s, device memory, the step's byte bound
     (``H100Model.lm_decode_step``) and p50 over it, and one step's
     device busy share and B5 share from ``torch.profiler``; then one
     step on the live cache with each B5 launch held against B5's plain
     version on the same inputs (``HeldB5``, at 2e-4 of scale);
   * 7b, decode against prefill: 4 prompts of 200-1,000 tokens, 24 new,
     each decode step's logits (B5) against a teacher-forced
     ``forward`` (plain attention) over the same tokens, in fp32
     (within 2e-3 of scale) and in bf16 (within ``TOL_LM_BF16``, the
     same argmax wherever the top two lie further apart than it), with
     every B5 launch of both runs held against its plain version at
     2e-4 of scale, the sharp check of the bf16 path;
   * 7c, past the window: 2 prompts of 4,000 tokens and 160 new, so the
     ring wraps; the same comparison, in fp32 and bf16;
   * 7d, minicpm-2b (40 layers, MHA, so G=1 and D=64: B5's CUDA-core
     path; tied head, vocab padded to 122,880) with 16 slots: 32
     requests of 64-512 tokens, 16 new; all complete, B5 launches = 40 x
     steps, finite logits, tokens/s, and one step on the live cache with
     its 40 B5 launches (bf16, G=1, D=64) held against the plain
     version.  phi3-medium-14b's fp32 params and their bf16 copy do not
     fit the card, so it does not run;
   * 7e, ``python -m repro_torch.launch.serve --arch h2o-danube-1.8b``
     with its defaults (8 requests), on the card: B5 launches = 24 x
     steps, each held against its plain version.

8. MoE-LM serving through ``LMEngine``: moonshot-v1-16b-a3b (48
   layers, d_model 2048, 16 / 16 heads of D=128, 64 experts top-6,
   vocab 163,840; 28.06 B params), its decode attention one B5 launch
   per layer (G=1, D=128: the CUDA-core path), its MoE in plain PyTorch
   (the reference's is plain XLA):
   * 8a, at full width with bf16 params (fp32 would be 112 GB; bf16 are
     the values the compute cast makes), 16 slots over a 2,048-slot
     cache, 48 requests of 64-1,024 prompt tokens and 32 new each: all
     complete, B5 launches = 48 x decode steps, finite logits; decode ms
     per step p50 / p99 against the step's bound
     (``H100Model.lm_decode_step``: every expert's matrices), one step's
     device busy share, events and B5 ms from ``torch.profiler``,
     prefill ms per rung, tokens/s, memory held and peak; then one
     decode step on the live cache and one 1,000-token prefill at the
     1,024 rung, with each B5 launch held against its plain version
     (``HeldB5``, 2e-4) and each layer's ``moe_apply`` at the served
     capacity, drops included, against a plain per-expert loop on the
     same x, expert ids and gates (``HeldMoE``, ``TOL_MOE_BF16``), and
     the share of assignments the capacity dropped;
   * 8b, full width cut to 4 layers in fp32 with a capacity factor of
     E / k (no drops): decode (B5) against a teacher-forced ``forward``
     on the served run's routing (``ForcedRoute``; where it differs from
     the forward's own top-k, at a tie below ``TIE_GAP``) at 2e-3 of
     scale, 4 prompts of 200-1,000 tokens inside the 1,024-slot cache,
     and 2 of 1,000 tokens with 64 new, past the ring (held against a
     forward with a 1,024-token window, what the ring holds); every B5
     launch held against its plain version.  The bf16 full-depth
     comparison is left out (see 8b's comment);
   * 8c, ``python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b``
     with its defaults, on the card: B5 launches = 48 x steps, each held.

9. LM training through ``launch.train``'s ``lm`` program (Adafactor,
   warmup-cosine, ``remat="layer"``, ``lm_batches`` of 8 x 256 tokens,
   the CLI's default lr): h2o-danube-1.8b at full width for 50 steps,
   its final checkpoint restored bitwise; moonshot-v1-16b-a3b at full
   width cut to 4 layers (fp32 params) for 50 steps, the MoE's backward
   through its dispatch.  ms per step, peak memory, the loss starting
   near ln(V) and finite; then ``FIT_STEPS`` of the program's steps on
   one batch lowering its loss by ``LOSS_FALL`` nats; no hand-written
   kernel launched.

10. the GNN zoo through ``launch.train``'s ``gnn`` program (AdamW,
   warmup-cosine, the program's 4,096-node, 16,384-edge, 64-feature
   graph every step), fp32 with TF32 off; no hand-written kernel runs
   (the reference's gathers and segment sums are XLA's, the port's
   torch's ``index_select`` / ``index_add`` / ``scatter_reduce``), and
   the phase asserts that B1-B5 launch 0 times:
   * 10a, each of gcn-cora (2 x 16), pna (4 x 75, 12 aggregated views),
     meshgraphnet (15 blocks x 128) and equiformer-v2 (12 layers, C=128,
     l_max 6, m_max 2, 8 heads) at full width: the forward at the
     reference's initial weights (``prng.key(0)``) on the card against
     the port's on the CPU (2e-4 of scale); one forward and backward
     under CUDA's sync debug mode "error"; then ``python -m
     repro_torch.launch.train --arch A --steps 50``: ms per step (CUDA
     events), peak memory, the step-0 loss against the reference's
     (``GNN_REF_LOSS``, computed by the JAX package on a CPU, 1e-4
     relative), the losses along the run against the reference's where
     its trajectory is reproducible (``GNN_REF_AT``, 1e-3 relative), and
     the step-49 loss below the step-0 loss;
   * 10b, equiformer-v2 at full width: its readout under a rotation of
     ``pos`` (5e-3 of scale) and a translation (5e-4), the chunked edge
     path at ``edge_chunk`` 4,096 (4 chunks) against the direct one
     (2e-4), and one train step under ``torch.profiler``: device busy
     share and the top device ops;
   * 10c, gcn-cora at ogb_products' size (2,449,029 nodes, 61,859,140
     edges, 100 features; ``GNN_SHAPES``) on one card: the forward
     against the port's on the CPU (2e-4 of scale) and a few train steps
     through the program's loss and ``make_train_step``: ms per step and
     peak memory.

11. the multi-device layer on a world-size-1 NCCL group over the card
   (the backend a multi-GPU deployment uses; NCCL takes one rank per
   card, so no collective here crosses a link):
   * 11a, jedinet-30p (full width, B=1,024) takes 5 AdamW steps on a
     (1, 1) ``("data", "model")`` DeviceMesh, its state placed by
     ``train_state_shardings`` and its batch by ``batch_shardings``
     inside ``axis_rules``: params, loss and grad norm against the
     unsharded steps on the card at 1e-4; then h2o-danube-1.8b cut to 2
     layers at full width in fp32, one Adafactor step with its
     ``param_shardings`` and the model's ``constrain`` calls active,
     against the unsharded step at 1e-4 of scale; ms per step;
   * 11b, ``ef_compressed_psum`` on the group (int32 sums) against its
     quantize / dequantize, bitwise; ``a2a_moe`` at one
     moonshot-v1-16b-a3b MoE layer at full width (64 experts, top-6,
     d_model 2,048, 1,024 tokens, fp32, capacity factor E/k) against
     ``moe_apply`` at 1e-5 of scale; ms of each;
   * 11c, ``fused_full`` at jedi_30p through ``ResilientEngine`` with
     ``shards=[cuda, cuda]`` (two shards on the one card): every
     256-event batch in bucket 256, B1 launched twice per served batch,
     no demotion and no counter, the logits against the one-shard
     engine's on the same batches (bitwise or not, printed); batches/s
     with 1 and 2 shards; these B1 launches join B1's count
     (``launches_by_phase["multidevice"]``);
   * 11d, 11a's sharded state saved and restored with
     ``restore(shardings=...)`` onto a 1-D ``("data",)`` mesh, bitwise.

12. the cell programs (``launch/steps.py``), the dry run
   (``launch/dryrun.py``) and the H100 roofline (``launch/roofline.py``):
   * 12a, on the card's host, one dry-run cell per family at full
     width on the 16 x 16 mesh of 256 fake ranks (jedinet-30p
     stream_1k, fm train_batch, gcn-cora minibatch_lg, h2o-danube-1.8b
     decode_32k): each ``status: ok``, its roofline terms, per-rank
     FLOPs, bytes, collective bytes and peak memory, and its time;
   * 12b, on a (1, 1) mesh over a world-size-1 NCCL group, at full width
     (weights from ``init(int)``, data from the repo's generators):
     jedinet-30p stream_1k (B=1,024) and train_jets (B=4,096), fm
     serve_bulk (B=262,144), gcn-cora full_graph_sm and h2o-danube-1.8b
     decode_32k (B=128, every one of the T=4,096 cache slots full).
     Each cell's step against the entry point it wraps on the same
     inputs (the train programs' steps, ``inet.forward_sr_split``,
     ``models.recsys.forward``, ``tfm.decode_step`` called directly),
     bitwise or within 1e-6 of scale; B5's launches of the entry
     point's step held against its plain version (``HeldB5``); ms per
     step of the cell's step and of its entry point on CUDA events (on
     the danube cell also B5 through its op against its launch called
     straight, ``dispatch_ab``); the roofline at chips=1 counted on the
     real step and each time's ratio to it; against the fake count of
     the same cell at chips=1, the FLOPs (1%), the step's inputs and
     what the step adds to them (15% each).  B5's launches here join
     its main-path count (``launches_by_phase["cells"]``).

13. the static analysis, ``python -m repro_torch.analysis --json --arch
   jedi_30p,jedi_50p,jedi_tracks_128`` in-process on the card: the five
   lint rules over the checkout, and the kernel-contract audit, which
   holds every registered kernel path at every rung of its ladder
   against the plan its wrapper launches, reads the five libraries'
   ptxas reports, resource usage and SASS (``cuobjdump`` beside
   ``nvcc``) and runs each registered path's forward once at its
   smallest rung (a kernel path launching its kernel once, the others
   none).  Exit status 0 and no finding; every library's ptxas report
   read; HMMA instructions found (each accumulating in F32, else a
   finding); the tightest register allocation of any plan printed.  The
   audit's launches join B1's, B2's and B3's counts
   (``launches_by_phase["analysis"]``).

Before the last line it prints a ``training: {...}`` line with phase
6's numbers, an ``lm: {...}`` line with phase 7's, a ``moe: {...}``
line with phase 8's, an ``lm_training: {...}`` line with phase 9's, a
``gnn: {...}`` line with phase 10's, a ``multidevice: {...}`` line with
phase 11's, a ``cells: {...}`` line with phase 12's, an ``analysis:
{...}`` line with phase 13's and one JSON object with each kernel's
numbers; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import math
import pathlib
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
        ("bf16 MHA G=1 D=64 (minicpm-2b, 7d)", (16, 36, 36, 64, 1024), None,
         None, bf16, None),
        ("bf16 D=80 G=4 B=4 S=128 (the serve CLI, 7e)", (4, 32, 8, 80, 128),
         None, None, bf16, None),
        ("bf16 MHA G=1 D=128 (moonshot-v1-16b-a3b, 8a)",
         (16, 16, 16, 128, 2048), None, None, bf16, None),
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


#: h2o-danube-1.8b's decode step as phase 7 serves it: 128 slots (the
#: LM family's decode_32k batch) over its rolling cache of T = 4,096
#: slots (the sliding window), bf16.
DANUBE_LM_DECODE = dict(b=128, s=4096, h=32, hkv=8, d=80)
#: moonshot-v1-16b-a3b's decode step as phase 8a serves it: 16 slots over
#: a 2,048-slot cache, MHA with 16 heads of D = 128 (G = 1: B5's CUDA-core
#: path), bf16, full attention.
MOONSHOT_LM_DECODE = dict(b=16, s=2048, h=16, hkv=16, d=128)


def lm_decode_timing(dev, shape=DANUBE_LM_DECODE, window=4096,
                     model="h2o-danube-1.8b", phase=7) -> Timing:
    """B5 at an LM path's own decode shape (phase 4): every slot full,
    with the model's window (None: full attention); against its plain
    version, with SDPA as the library call.  Its launches are filled in
    from ``phase``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import kernel as FDK

    b, s, h, hkv, d = (shape[n] for n in ("b", "s", "h", "hkv", "d"))
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v, _, kv_pos = decode_inputs(gen, dev, b, h, hkv, d, s,
                                       torch.bfloat16, causal=False,
                                       q_pos=[0] * b)
    q_pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    qg = scaled_groups(q, hkv)
    out = FDK.flash_decode_kernel_call(qg, k, v, q_pos, kv_pos,
                                       window=window)
    ref = FDK.flash_decode_ref(qg, k, v, q_pos, kv_pos, window=window)
    err, rel = err_of(out, ref)
    lay = FDK.plan(b, hkv, h // hkv, d, s, k.element_size())
    label = (f"{model} LM decode B={b} S={s} H={h} Hkv={hkv} D={d} bf16"
             + (f" window {window}" if window else ""))
    check(bool(torch.isfinite(out).all()) and rel <= TOL_FM_DECODE,
          f"flash_decode at {label}: vs plain max|err| {err:.3e} ({rel:.2e} "
          f"of scale, tol {TOL_FM_DECODE:g}); plan: {lay.n_parts} partitions"
          f" of {lay.part_len} keys, {lay.blocks} blocks of {lay.heads} "
          f"warp(s), {lay.stages}-stage ring, {lay.path} path")
    del ref
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    qb = q.to(torch.bfloat16)[:, :, None, :]
    ok = (kv_pos >= 0) & (kv_pos <= q_pos[:, None]) \
        & ((q_pos[:, None] - kv_pos) < s)
    mask = ok[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qb, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    ops_, nbytes = decode_work(b, s, h, hkv, d, k.element_size())
    return Timing(
        label, lambda: FDK.flash_decode_kernel_call(qg, k, v, q_pos, kv_pos,
                                                    window=window),
        lambda: FDK.flash_decode_ref(qg, k, v, q_pos, kv_pos, window=window),
        ops_, nbytes, err, 0, reps=50, plain_reps=5, library=sdpa,
        library_name="scaled_dot_product_attention (bf16, enable_gqa, "
                     "boolean mask)",
        extra={"main_path": f"models.transformer.decode_step (phase {phase})",
               "partitions": lay.n_parts, "partition_keys": lay.part_len,
               "stages": lay.stages, "path": lay.path, "blocks": lay.blocks,
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


def fault_counters(counters: dict) -> dict:
    """An engine's counters without the staging and output rings'
    (``serving.core.STAGING_COUNTERS``, ``D2H_COUNTERS``), which count
    every chunk staged on the card and every output copied back."""
    from repro_torch.serving.core import D2H_COUNTERS, STAGING_COUNTERS
    quiet = STAGING_COUNTERS + D2H_COUNTERS
    return {k: v for k, v in counters.items() if k not in quiet}


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
    base = counted(lambda: plain.run_stream(stream, warmup=2))
    res = counted(lambda: eng.run_stream(stream, warmup=2))
    eng.sentinel.drain()
    eng.sentinel.close()
    share = res["wall_s"] / base["wall_s"] - 1
    shadows = {"shadow_requests": c.get("shadow_requests", 0),
               "on_worker_stream": on_worker, "bitwise_equal": bitwise,
               "stream_wall_s": res["wall_s"],
               "plain_stream_wall_s": base["wall_s"],
               "sentinel_share": share}
    print(f"  stream wall {res['wall_s'] * 1e3:.3f} ms with the sentinel, "
          f"{base['wall_s'] * 1e3:.3f} ms without ({share:+.1%}; "
          f"{len(stream)} batches of {batch}, canary_every 64, shadow 1/4)"
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


#: jedinet-30p at train_jets (B=4096), 300 AdamW steps at lr 2e-3, seed 0:
#: the JAX reference's held-out accuracy on the CPU (its train CLI, then
#: ``repro_torch.examples.train_jedinet`` restoring its checkpoint and
#: evaluating it).  The port starts from the same initial weights
#: (``common/prng.py`` replays the reference's draw), but 300 AdamW steps
#: carry summation-order differences far apart, so phase 6 asks the
#: port's run on the card for at least half of the reference's gain over
#: the 20% chance level.
REF_ACC_30P_4096 = 0.7803
CHANCE = 0.2
ACC_MIN = CHANCE + 0.5 * (REF_ACC_30P_4096 - CHANCE)


class _Tee:
    """Writes to several text streams at once (stdout and a buffer)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _run_main(argv, *, injected: bool = False):
    """``repro_torch.launch.train.main(argv)`` with its output echoed and
    kept: (result, output).  With ``injected``, the run must raise the
    injected failure, which is returned in place of the result."""
    import contextlib
    import io

    from repro_torch.launch import train as train_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        if not injected:
            return train_cli.main(argv), buf.getvalue()
        try:
            train_cli.main(argv)
        except RuntimeError as e:
            return e, buf.getvalue()
    return None, buf.getvalue()


def _step_layers(card: str, label: str, step_fn, batches, opt, loss_fn,
                 state, batch_np, cm_dir) -> dict:
    """Time each layer of one train step at ``label``'s shape: host data
    generation, the pinned H2D copy, forward+backward, the optimizer
    update, the whole step on a batch already on the card, and the
    checkpoint snapshot (host copy of the state) that ``save_async``
    makes before it returns.  CUDA events; host clock for the host's
    parts."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import to_device
    from repro_torch.training import Optimizer, make_train_step
    from repro_torch.common.tree import param_bytes, tree_leaves

    dev = tree_leaves(state["params"])[0].device
    t0 = time.perf_counter()
    for _ in range(3):
        next(batches)
    data_ms = (time.perf_counter() - t0) / 3 * 1e3
    h2d_ms = time_ms(lambda: to_device(batch_np, dev), 5)
    batch = to_device(batch_np, dev)
    grads_box = {}

    def keep(grads, st, params, step):
        grads_box["g"] = grads
        return params, st, {}

    fwd_bwd = make_train_step(loss_fn, Optimizer(lambda p: {}, keep))
    fb_ms = time_ms(lambda: fwd_bwd({"params": state["params"], "opt": {},
                                     "step": state["step"]}, batch), 3)
    upd_ms = time_ms(lambda: opt.update(grads_box["g"], state["opt"],
                                        state["params"], state["step"]), 3)
    del grads_box["g"]
    step_ms = time_ms(lambda: step_fn(state, batch), 3)
    snap = {}
    if cm_dir is not None:
        cm = CheckpointManager(cm_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cm.save_async(0, state)
        snap["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
        cm.wait()
        snap["state_bytes"] = param_bytes(state)
    out = {"data_ms": data_ms, "h2d_ms": h2d_ms, "fwd_bwd_ms": fb_ms,
           "update_ms": upd_ms, "step_ms": step_ms, **snap}
    print(f"  {label} layers: data {data_ms:.3f} ms (host), H2D "
          f"{h2d_ms:.4f} ms, forward+backward {fb_ms:.4f} ms, optimizer "
          f"update {upd_ms:.4f} ms, step on a card batch {step_ms:.4f} ms"
          + (f", checkpoint snapshot {snap['snapshot_ms']:.3f} ms (host "
             f"copy of {snap['state_bytes'] / 1e6:.3f} MB)" if snap else "")
          + f"  [{card}]")
    return out


def training(dev, card: str, kernels, b1: Kernel) -> dict:
    """Phase 6: the training stack on the card (plain PyTorch forward and
    backward, as the reference trains through XLA), then the trained
    JEDI-net served through B1.  Returns B1's launches in the serving
    run (counts set to 0 just before it and read just after) and the
    phase's numbers."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import fm, jedi_30p
    from repro_torch.core import interaction_net as inet
    from repro_torch.data.jets import jet_batches
    from repro_torch.data.recsys_data import ctr_batches
    from repro_torch.examples import codesign_search
    from repro_torch.examples.train_jedinet import held_out_accuracy
    from repro_torch.launch import train as train_cli
    from repro_torch.models import recsys
    from repro_torch.serving.resilient import ResilientEngine
    from repro_torch.training import init_state

    out: dict = {}
    cfg = jedi_30p.MODEL
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # -- a. jedinet-30p at train_jets through the train CLI ------------
        print("== 6a. train jedinet-30p at train_jets (B=4096) on the card")
        b = 4096
        ckpt = f"{tmp}/jedi"
        zero_counts(kernels)
        res, _ = _run_main([
            "--arch", "jedinet-30p", "--device", str(dev), "--steps", "300",
            "--batch", str(b), "--lr", "2e-3", "--ckpt-dir", ckpt,
            "--ckpt-every", "100", "--log-every", "50"])
        first, last = res["history"][0][1], res["history"][-1][1]
        acc = held_out_accuracy(res["state"]["params"], cfg, dev)
        check(all(np.isfinite(m["loss"]) for _, m in res["history"])
              and last["loss"] < first["loss"],
              f"jedinet-30p B={b}: loss {first['loss']:.4g} at step 0 -> "
              f"{last['loss']:.4g} at step {res['history'][-1][0]}, finite")
        check(acc >= ACC_MIN,
              f"jedinet-30p B={b}: held-out accuracy {acc:.4f} (2048 events "
              f"of jet_batches(999)) >= {ACC_MIN:.4f}, half the reference's "
              f"gain over chance ({REF_ACC_30P_4096} on the CPU)")
        check(sum(k.counter.launches for k in kernels) == 0,
              "training launched no hand-written kernel (plain PyTorch "
              "forward and backward, as the reference's XLA)")
        print(f"  jedinet-30p B={b}: {res['ms_per_step']:.3f} ms/step over "
              f"the loop ({1e3 / res['ms_per_step']:.2f} it/s, CUDA events, "
              f"data from the prefetch thread)  [{card}]")
        init_fn, step_fn, batches, opt = train_cli.make_program(
            "jedinet-30p", b, 2e-3, dev)
        layers = _step_layers(
            card, f"jedinet-30p B={b}", step_fn, batches, opt,
            lambda p, bb: inet.loss_fn(p, cfg, bb),
            init_state(0, init_fn, opt),
            next(jet_batches(5, b, cfg.n_objects)), f"{tmp}/snap")
        out["jedinet_30p"] = {
            "batch": b, "steps": res["steps"],
            "loop_ms_per_step": res["ms_per_step"],
            "first_loss": first["loss"], "last_loss": last["loss"],
            "held_out_accuracy": acc, **layers}

        # -- b. crash and restart ------------------------------------------
        print("== 6b. crash and restart on the card")
        argv = ["--arch", "jedinet-30p", "--device", str(dev), "--steps", "60",
                "--batch", "1024", "--lr", "2e-3", "--ckpt-dir",
                f"{tmp}/crash", "--ckpt-every", "25", "--log-every", "30"]
        err, _ = _run_main(argv + ["--fail-at-step", "30"], injected=True)
        check(err is not None and "injected failure" in str(err),
              f"--fail-at-step 30 fails: {err}")
        _, text = _run_main(argv)
        check("restored checkpoint at step 25" in text
              and "final checkpoint at step 60" in text,
              "the rerun restores step 25 and ends with the final "
              "checkpoint at step 60")

        # -- c. the trained weights through B1 ----------------------------
        print("== 6c. the trained jedinet-30p served through B1")
        state, step = CheckpointManager(ckpt).restore(device=dev)
        same = all(torch.equal(a, c) for a, c in zip(
            tree_leaves(state["params"]), tree_leaves(res["state"]["params"])))
        check(step == 300 and same,
              f"final checkpoint restored at step {step}, params bitwise "
              "equal to the trained ones")
        held = next(jet_batches(999, 2048, cfg.n_objects, cfg.n_features))
        xs = np.split(held["x"], 8)
        y = held["y"]
        with torch.no_grad():
            ref = torch.cat([inet.forward_sr(state["params"], cfg,
                                             torch.from_numpy(x).to(dev))
                             for x in xs]).cpu().numpy()
        ref_acc = float((ref.argmax(-1) == y).mean())
        served, b1_launches = {}, 0
        for path in ("fused_full", "int8_fused_full"):
            engine = ResilientEngine(state["params"], cfg, forward=path,
                                     device=dev, max_batch=256)
            engine.infer(xs[0])                  # build the bucket
            zero_counts(kernels)
            logits = np.concatenate([engine.infer(x) for x in xs])
            torch.cuda.synchronize()
            launches = b1.counter.launches
            b1_launches += launches
            health = engine.health()
            quiet = fault_counters(health["counters"])
            check(not quiet
                  and engine.active_path(256) == path
                  and launches == len(xs),
                  f"{path}: {launches} B1 launches for {len(xs)} batches of "
                  f"256, active path {engine.active_path(256)}, counters "
                  f"{quiet or 'none'}")
            served[path] = (logits, float((logits.argmax(-1) == y).mean()))
        logits, acc_b1 = served["fused_full"]
        scale = max(1.0, float(np.abs(ref).max()))
        err_b1 = float(np.abs(logits - ref).max())
        top2 = np.sort(ref, -1)[:, -2:]
        near = top2[:, 1] - top2[:, 0] <= 2 * TOL_FP32 * scale
        flips = logits.argmax(-1) != ref.argmax(-1)
        check(err_b1 <= TOL_FP32 * scale,
              f"fused_full vs forward_sr on the trained weights: max|err| "
              f"{err_b1:.3e} ({err_b1 / scale:.2e} of scale, tol "
              f"{TOL_FP32:g})")
        check(not (flips & ~near).any(),
              f"fused_full accuracy {acc_b1:.4f} vs forward_sr {ref_acc:.4f}"
              f" on the held-out 2048 events: {int(flips.sum())} argmax "
              f"flips, all among {int(near.sum())} events whose top two "
              "logits lie within the tolerance")
        acc_int8 = served["int8_fused_full"][1]
        print(f"  int8_fused_full accuracy {acc_int8:.4f} beside fused_full "
              f"{acc_b1:.4f} and forward_sr {ref_acc:.4f}  [{card}]")
        out["jedinet_30p"].update(
            served_accuracy={"fused_full": acc_b1,
                             "int8_fused_full": acc_int8,
                             "forward_sr": ref_acc},
            served_max_abs_err=err_b1)
        del state, res, served
        torch.cuda.empty_cache()

        # -- d. fm at full width --------------------------------------------
        print("== 6d. train fm at full width (B=65,536) on the card")
        b = fm.ARCH.shapes["train_batch"].dim("batch")
        mcfg = fm.MODEL
        held = train_cli.to_device(next(ctr_batches(1, b, mcfg.vocab_sizes)),
                                   dev)
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()
        zero_counts(kernels)
        res, _ = _run_main([
            "--arch", "fm", "--device", str(dev), "--steps", "16", "--batch",
            str(b), "--lr", "1e-2", "--log-every", "5"])
        peak = torch.cuda.max_memory_allocated() - held_before
        state = res["state"]
        init_loss = math.log(2.0)
        with torch.no_grad():
            held_loss = float(recsys.loss_fn(state["params"], mcfg, held)[0])
        first, last = res["history"][0][1], res["history"][-1][1]
        check(np.isfinite(held_loss) and held_loss < init_loss
              and all(np.isfinite(m["loss"]) for _, m in res["history"]),
              f"fm B={b}: held-out loss (ctr_batches(1)) {held_loss:.6f} < "
              f"{init_loss:.6f} at init (logits ~0); train loss "
              f"{first['loss']:.6f} -> {last['loss']:.6f}")
        check(sum(k.counter.launches for k in kernels) == 0,
              "fm training launched no hand-written kernel (use_kernel="
              "False, as the reference trains)")
        rows = recsys.padded_rows(mcfg)
        print(f"  fm B={b}, {rows:,} rows of K={mcfg.embed_dim}: "
              f"{res['ms_per_step']:.3f} ms/step over the loop "
              f"({1e3 / res['ms_per_step']:.2f} it/s, CUDA events), peak "
              f"device memory {peak / 2**30:.2f} GiB above the "
              f"{held_before / 2**30:.2f} GiB held before the run  [{card}]")
        _, step_fn, batches, opt = train_cli.make_program("fm", b, 1e-2, dev)
        layers = _step_layers(
            card, f"fm B={b}", step_fn, batches, opt,
            lambda p, bb: recsys.loss_fn(p, mcfg, bb), state,
            next(ctr_batches(5, b, mcfg.vocab_sizes)), None)
        out["fm"] = {"batch": b, "rows": rows, "steps": res["steps"],
                     "loop_ms_per_step": res["ms_per_step"],
                     "peak_gib": peak / 2**30,
                     "held_before_gib": held_before / 2**30,
                     "held_out_loss": held_loss,
                     "first_loss": first["loss"], "last_loss": last["loss"],
                     **layers}
        del state, res, held
        torch.cuda.empty_cache()

        # -- e. the co-design loop ------------------------------------------
        print("== 6e. the co-design loop (examples.codesign_search, 150 "
              "steps each)")
        designs = codesign_search.main(["--device", str(dev)])
        check(list(designs) == ["J1-baseline", "Opt-Latn", "Opt-Acc"]
              and all(0.0 <= d["accuracy"] <= 1.0
                      and np.isfinite(d["latency_us"])
                      for d in designs.values()),
              "three designs trained on the card: " + ", ".join(
                  f"{n} {d['latency_us']:.2f} us {d['accuracy']:.4f}"
                  for n, d in designs.items()))
        out["codesign"] = {n: {"latency_us": d["latency_us"],
                               "accuracy": d["accuracy"]}
                           for n, d in designs.items()}
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    out["b1_launches"] = b1_launches
    return out


def time_row(k: Kernel, t: Timing, card: str, peak_flops: float,
             peak_bytes: float) -> dict:
    """Phase 4's numbers of one timing case, printed and returned as a row
    of the kernels' JSON line: the kernel's, its plain version's and the
    library call's times (CUDA events), and the bound (the larger of the
    operations at the fp32 peak and the bytes at the HBM rate)."""
    windows = []
    ms = time_ms(t.run, t.reps, windows)
    plain_ms = time_ms(t.plain, t.plain_reps)
    library_ms = time_ms(t.library, t.reps) if t.library else None
    t_ops = t.ops / peak_flops * 1e3
    t_bytes = t.nbytes / peak_bytes * 1e3
    bound_ms = max(t_ops, t_bytes)
    lib = (f"; {t.library_name} {library_ms:.4f} ms" if t.library else
           "; no single PyTorch call computes this function")
    print(f"  {k.name} at {t.label}: {ms:.4f} ms (windows "
          f"{windows[0][0]:.4f}-{windows[0][1]:.4f}; plain version "
          f"{plain_ms:.4f} ms{lib}); bound {bound_ms:.4f} ms "
          f"({t.ops / 1e9:.4f} GFLOP at 67 TFLOP/s fp32 vs "
          f"{t.nbytes / 1e6:.3f} MB at 3.35 TB/s)  [{card}]")
    return {
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "launches": t.launches,
        "max_abs_err": t.max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms, "ms_windows": windows[0],
        "at": t.label, **t.extra, "card": card}


# ---- phase 7: dense LM serving ------------------------------------------------

#: 7b / 7c, fp32: decode through B5 against a teacher-forced ``forward``
#: (plain attention) over the same tokens, at the reference's own
#: decode-vs-prefill bar (tests/test_transformer.py), on logits scaled to
#: max(1, max |logit|).
TOL_LM_FP32 = 2e-3
#: bf16, the same comparison.  The two runs compute one function with
#: other roundings: the decode step's products run at M = 2-128 rows and
#: the forward's at M = S (cuBLAS sums in another order), and B5 keeps p
#: at fp32 accuracy where the plain attention casts p to bf16.  Once one
#: value lands on the other side of a bf16 rounding, the two runs round
#: independently from there on.  Each of the ~11 roundings a layer takes
#: on the residual stream's way (q, k, v, the attention output, wo, two
#: residual adds, gate, up, their product, down) moves its value by up
#: to 2^-9 of it, 2^-9 / sqrt(3) rms; over 24 layers and two runs the
#: final hidden state differs by sqrt(2 * 11 * 24) * 2^-9 / sqrt(3) =
#: 2.6e-2 rms of its size.  A logit, a sum over d_model such terms with
#: random head weights, moves by that fraction of its own spread; the
#: largest move over the ~3M logits compared (4 prompts x 23 steps x
#: 32,000) lies ~5 spreads out and max |logit| ~4.3 spreads out, so the
#: gap is ~3e-2 of scale, and one bf16 ulp of a logit (2^-8 of it)
#: comes on top; later steps attend over caches that already differ, so
#: the gap grows along a generation (PERF.md §6 has the measured gaps).
#: The bar is 5e-2, the reference's bf16 bar for B5
#: (tests/test_kernels.py); a wrong mask, slot or position, which this
#: check is for, moves logits by O(1) of scale.  Wherever the top two
#: logits of the forward lie further apart than the bar, the argmax must
#: agree.  This end-to-end bar cannot tell B5 from cuBLAS's order, so
#: every B5 launch of the bf16 runs is also held against B5's plain
#: version on the same inputs at TOL_FM_DECODE (:class:`HeldB5`): that
#: is the sharp check of the bf16 path.  (A bf16 run lies further from
#: an fp32 forward than from a bf16 one: two bf16 runs share their
#: roundings until they part, so an fp32 reference gives no sharper bar.)
TOL_LM_BF16 = 5e-2


class HeldB5:
    """Inside ``with``, every B5 launch the model makes is held against
    B5's plain version on the same inputs: the step's own q, the live
    cache after this step's write, its ``slot_pos`` (empty slots
    included) and the window.  ``decode_step`` calls
    ``FDK.flash_decode_kernel_call`` through its module, so this object
    stands in there and launches the kernel once, as the step would; the
    step goes on with the kernel's output.  The kernel counts its launch
    on the module's name, so ``launches`` reads and writes the kernel's
    own counter: one count per launch, as without the check.  Errors are
    device scalars, read by :meth:`check` after the run."""

    def __init__(self):
        from repro_torch.kernels.flash_decode import kernel as FDK
        self._fdk, self._launch = FDK, FDK.flash_decode_kernel_call
        self.errs, self.empty, self.shapes = [], [], set()

    @property
    def launches(self) -> int:
        return self._launch.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self._launch.launches = n

    def __call__(self, q, k, v, q_pos, kv_pos, *, chunk=None, window=None):
        out = self._launch(q, k, v, q_pos, kv_pos, chunk=chunk,
                           window=window)
        ref = self._fdk.flash_decode_ref(q, k, v, q_pos, kv_pos,
                                         window=window)
        self.errs.append((out - ref).abs().max()
                         / ref.abs().max().clamp_min(1.0))
        self.empty.append((kv_pos < 0).float().mean())
        b, hkv, g, d = q.shape
        self.shapes.add(f"B={b} T={k.shape[1]} Hkv={hkv} G={g} D={d} "
                        f"{str(k.dtype)[6:]} window {window}")
        return out

    def __enter__(self):
        self._fdk.flash_decode_kernel_call = self
        return self

    def __exit__(self, *exc):
        self._fdk.flash_decode_kernel_call = self._launch

    def check(self, label: str) -> dict:
        worst = float(torch.stack(self.errs).max()) if self.errs else math.inf
        empty = float(torch.stack(self.empty).mean()) if self.empty else 0.0
        check(worst <= TOL_FM_DECODE,
              f"{label}: each of {len(self.errs)} B5 launches vs its plain "
              f"version on the same q, live cache and slot_pos "
              f"({empty:.1%} of the slots empty): max|err| {worst:.3e} of "
              f"max(1, |out|) (tol {TOL_FM_DECODE:g}); "
              f"{', '.join(sorted(self.shapes))}")
        return {"b5_launches_held": len(self.errs),
                "b5_vs_plain_of_scale": worst, "empty_slot_share": empty}


#: Interleaved pairs of each A/B of B5's op dispatch (phases 4 and 12b).
DISPATCH_PAIRS = 12


class B5Straight:
    """Inside ``with``, B5 calls made through the module skip the op
    ``repro_torch::flash_decode``: its wrapper's checks, then the op's
    CUDA kernel (``_launch``) called straight, so :func:`dispatch_ab`
    can price the op's host dispatch.  The launch counts on the module's
    name, so ``launches`` is the kernel's own counter, as in
    :class:`HeldB5`."""

    def __init__(self):
        from repro_torch.kernels.flash_decode import kernel as FDK
        self._fdk, self._call = FDK, FDK.flash_decode_kernel_call

    @property
    def launches(self) -> int:
        return self._call.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self._call.launches = n

    def __call__(self, q, k, v, q_pos, kv_pos, *, chunk=None, window=None):
        self._fdk._check(q, k, v, q_pos, kv_pos, window)
        return self._fdk._launch(q, k, v, q_pos, kv_pos, chunk, window)

    def __enter__(self):
        self._fdk.flash_decode_kernel_call = self
        return self

    def __exit__(self, *exc):
        self._fdk.flash_decode_kernel_call = self._call


def dispatch_ab(label: str, fn, reps: int,
                pairs: int = DISPATCH_PAIRS) -> dict:
    """``fn()`` with B5 through its op against B5 called straight
    (:class:`B5Straight`), in ``pairs`` interleaved pairs (op, straight,
    straight, op, ...): per call, the host's enqueue time (perf_counter
    around ``reps`` calls, no sync between them) and the device's (CUDA
    events around the same calls), after two warm calls.  Each side's
    median and spread (max - min); ``beyond_spread`` says whether the
    straight call's median beats the op's by more than the op's own
    spread."""
    readings = {"op": ([], []), "straight": ([], [])}
    for i in range(pairs):
        for side in ("op", "straight")[::1 if i % 2 == 0 else -1]:
            with B5Straight() if side == "straight" else \
                    contextlib.nullcontext():
                for _ in range(2):
                    fn()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                host = time.perf_counter() - t0
                stop.record()
                torch.cuda.synchronize()
            readings[side][0].append(host / reps * 1e6)
            readings[side][1].append(start.elapsed_time(stop) / reps)
    out: dict = {"pairs": pairs, "reps": reps}
    for side, (host_us, ms) in readings.items():
        out[side] = {"host_us": float(np.median(host_us)),
                     "host_us_range": [min(host_us), max(host_us)],
                     "ms": float(np.median(ms)), "ms_range": [min(ms), max(ms)]}
    op, st = out["op"], out["straight"]
    out["gain_host_us"] = op["host_us"] - st["host_us"]
    out["gain_ms"] = op["ms"] - st["ms"]
    out["op_spread_ms"] = op["ms_range"][1] - op["ms_range"][0]
    out["beyond_spread"] = out["gain_ms"] > out["op_spread_ms"]
    print(f"  B5 dispatch A/B, {label}, {pairs} interleaved pairs of {reps} "
          f"calls: through the op {op['ms']:.4f} ms (range "
          f"{op['ms_range'][0]:.4f}-{op['ms_range'][1]:.4f}), host "
          f"{op['host_us']:.1f} us; straight {st['ms']:.4f} ms (range "
          f"{st['ms_range'][0]:.4f}-{st['ms_range'][1]:.4f}), host "
          f"{st['host_us']:.1f} us; the straight call gains "
          f"{out['gain_ms']:.4f} ms and {out['gain_host_us']:.1f} us of host "
          f"a call, beyond the op's spread {out['op_spread_ms']:.4f} ms: "
          f"{out['beyond_spread']}")
    return out


def lm_engine(params, cfg, dev, *, record: bool = False, **kw):
    """An ``LMEngine`` on ``dev`` that notes whether the logits of every
    prefill and decode step it serves are finite (device flags, read after
    the run) and, with ``record``, keeps each decode step's logits.  Both
    happen after each ``_admit`` and ``step`` returns, outside the
    engine's timed spans, and no logits are held past them."""
    from repro_torch.serving import LMEngine

    class Checked(LMEngine):
        def compiled_for(self, bucket):
            fn = super().compiled_for(bucket)

            def run(*args):
                out = fn(*args)
                if self.stepping:
                    self.served.append((bucket, out[0]))
                return out
            return run

        def _take_served(self):
            for bucket, logits in self.served:
                self.finite.append(torch.isfinite(logits).all())
                if record and bucket == "decode":
                    self.decode_logits.append(logits.clone())
            self.served.clear()

        def _admit(self, slot, req):
            super()._admit(slot, req)
            self._take_served()

        def step(self):
            self.stepping = True
            try:
                return super().step()
            finally:
                self.stepping = False
                self._take_served()

    eng = Checked(params, cfg, device=dev, **kw)
    eng.stepping, eng.served, eng.finite, eng.decode_logits = \
        False, [], [], []
    return eng


def device_shares(fn, kernel: str, steps: int = 3, top: int = 8) -> dict:
    """Per call of ``fn``: wall ms (CUDA events), and from
    ``torch.profiler``'s device-side events (the kernels and copies
    themselves, not the host ops that launched them) the device time of
    all, of those whose names hold ``kernel`` and of the ``top`` largest
    by name, and the number of device events; shares of the wall, or
    None without a trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    wall = time_ms(fn, steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    total = named = 0.0
    events = 0
    by_name = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        t = ev.device_time_total
        total += t
        events += ev.count
        by_name[ev.key] = t / steps / 1e3
        if kernel in ev.key:
            named += t
    if total <= 0:
        return {"wall_ms": wall, "device_ms": None, "kernel_ms": None,
                "busy_share": None, "kernel_share": None, "top_ms": {},
                "device_events": None}
    dev_ms, k_ms = total / steps / 1e3, named / steps / 1e3
    largest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall, "device_ms": dev_ms, "kernel_ms": k_ms,
            "busy_share": dev_ms / wall, "kernel_share": k_ms / wall,
            "device_events": events / steps,
            "top_ms": {name[:90]: ms for name, ms in largest}}


def lm_prompts(rng, vocab: int, n: int, lo: int, hi: int) -> list:
    """``n`` prompts of ``lo``-``hi`` tokens (inclusive), drawn from ``rng``."""
    return [rng.randint(0, vocab, int(length))
            for length in rng.randint(lo, hi + 1, n)]


def served_checks(label, eng, report, n_req, max_new, launches, others,
                  n_layers) -> None:
    done = report["done"]
    check(len(done) == n_req and report["shed"] == 0
          and all(len(r.out) == max_new and not r.shed for r in done),
          f"{label}: {len(done)} of {n_req} requests done with {max_new} "
          f"tokens each, {report['shed']} shed")
    check(launches == n_layers * report["steps"] and not others,
          f"{label}: {launches} flash_decode launches == {n_layers} layers x "
          f"{report['steps']} decode steps; other kernels {others or 'none'}")
    finite = bool(torch.stack(eng.finite).all())
    check(finite, f"{label}: every prefill's and decode step's logits "
                  f"finite ({len(eng.finite)} calls)")


def logit_gap(got, want, tol: float) -> tuple[float, int, int]:
    """Decode logits against a forward's, (positions, V): the largest
    error over max(1, max |want|), the argmax flips where the forward's top
    two lie further apart than ``tol`` of that scale, and the count of
    such positions."""
    scale = max(1.0, float(want.abs().max()))
    top2 = want.topk(2, -1).values
    sure = (top2[:, 0] - top2[:, 1]) > tol * scale
    flips = int(((got.argmax(-1) != want.argmax(-1)) & sure).sum())
    return float((got - want).abs().max()) / scale, flips, int(sure.sum())


def decode_vs_forward(label, eng, cfg, report, tol: float) -> dict:
    """Each request's decode logits (B5, recorded per step) against
    ``forward`` over its prompt and its generated tokens (teacher forced,
    plain attention) with the engine's own weights, at ``cfg`` (the
    engine's, or one whose window covers what the decode ring holds): the
    largest error over max(1, max |logit|), and argmax flips where the
    forward's top two lie further apart than ``tol`` of that scale
    (``clear_positions`` counts those positions)."""
    from repro_torch.models import transformer as tfm
    params = eng.workload.compute_params()
    dec = torch.stack(eng.decode_logits)            # (steps, slots, V)
    worst, flips, clear, rows = 0.0, 0, 0, 0
    for slot, r in enumerate(report["done"]):       # rid s sat in slot s
        pl, n = len(r.prompt), len(r.out)
        toks = torch.from_numpy(np.concatenate(
            [r.prompt, r.out[:-1]]).astype(np.int32))[None].to(eng.device)
        with tfm.xla_rounding():
            want = tfm.forward(params, cfg, toks)[0][0, pl:].float()
        err, f, c = logit_gap(dec[:n - 1, slot], want, tol)
        worst, flips, clear, rows = max(worst, err), flips + f, clear + c, \
            rows + n - 1
        del want
    check(worst <= tol and flips == 0,
          f"{label}: decode (B5) vs teacher-forced forward over {rows} "
          f"positions: max|err| {worst:.3e} of scale (tol {tol:g}); argmax "
          f"flips {flips} of {clear} positions whose top two lie > tol apart")
    return {"max_err_of_scale": worst, "positions": rows,
            "clear_positions": clear, "argmax_flips": flips}


def lm_serving(dev, card: str, kernels, b5: Kernel) -> dict:
    """Phase 7: dense-LM serving at full width through ``LMEngine``, the
    decode step's attention on B5.  Returns the phase's numbers, with
    B5's launches by run under ``b5_launches``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.codesign import H100Model, H100_BF16_FLOPS, \
        H100_HBM_BPS
    from repro_torch.kernels.flash_decode import kernel as FDK
    from repro_torch.models import transformer as tfm

    out = {"b5_launches": {}}
    base = torch.cuda.memory_allocated()      # what earlier phases hold

    def launches_of(run: str) -> tuple[int, dict]:
        others = {k.name: k.counter.launches for k in kernels
                  if k is not b5 and k.counter.launches}
        out["b5_launches"][run] = b5.counter.launches
        return b5.counter.launches, others

    # -- 7a. h2o-danube-1.8b at full width, 128 slots ----------------------
    print("== 7a. h2o-danube-1.8b served at full width (LMEngine, B5)")
    spec = get_arch("h2o-danube-1.8b")
    cfg = spec.model
    slots = spec.shapes["decode_32k"].dim("global_batch")
    max_seq, n_req, max_new = cfg.sliding_window, 192, 32
    t0 = time.perf_counter()
    params = tfm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    eng = lm_engine(params, cfg, dev, slots=slots, max_seq=max_seq)
    zero_counts(kernels)
    t0 = time.perf_counter()
    eng.warm()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm_launches = b5.counter.launches
    eng.finite.clear()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() - base
    prompts = lm_prompts(np.random.RandomState(0), cfg.vocab_size, n_req, 64,
                         2048)
    for p in prompts:
        eng.submit(p, max_new)
    zero_counts(kernels)
    report = eng.run()
    wall, step_s = report["wall_s"], report["decode_step_s"]
    launches, others = launches_of("danube_serving")
    peak = torch.cuda.max_memory_allocated() - base
    served_checks("h2o-danube-1.8b slots=128", eng, report, n_req, max_new,
                  launches, others, cfg.n_layers)
    rungs = sorted({eng.bucket_for(len(p)) for p in prompts})
    check(report["prefill_compiles"] == len(eng.bucket_sizes)
          and eng.metrics.counter("prefills") == n_req,
          f"h2o-danube-1.8b: {report['prefill_compiles']} prefill builds for "
          f"the {len(eng.bucket_sizes)} rungs {eng.bucket_sizes} (warmed), "
          f"{eng.metrics.counter('prefills')} prefills on rungs {rungs}")
    tokens = eng.metrics.counter("tokens_emitted")
    dec_tokens = tokens - n_req
    p50, p99 = (float(np.percentile(step_s, q)) * 1e3 for q in (50, 99))
    flops, nbytes = H100Model.lm_decode_step(cfg, slots, max_seq)
    bound_ms = max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BPS) * 1e3
    print(f"  init {t_init:.2f} s (fp32 params, torch on the card), warm "
          f"{t_warm:.2f} s ({len(eng.bucket_sizes)} prefill rungs + decode, "
          f"{warm_launches} flash_decode launches, counted apart)  [{card}]")
    print(f"  {n_req} requests, {report['steps']} decode steps, {tokens} "
          f"tokens in {wall:.3f} s: {tokens / wall:,.1f} tokens/s "
          f"({dec_tokens / sum(step_s):,.1f} decode tokens/s over the "
          f"steps)  [{card}]")
    print(f"  decode step (128 slots, T={max_seq}): p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; bound {bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB: "
          f"bf16 weights + K/V over all T slots, at 3.35 TB/s; "
          f"{flops / 1e12:.3f} TFLOP at 989 TFLOP/s); p50 / bound "
          f"{p50 / bound_ms:.2f}  [{card}]")
    print(f"  device memory above the {base / 2**30:.2f} GiB earlier phases "
          f"hold: {held / 2**30:.2f} GiB before the run (fp32 params, their "
          f"bf16 copy, the cache), peak {peak / 2**30:.2f} GiB  [{card}]")
    rng = np.random.RandomState(5)
    prefill_ms = {}
    for r in rungs:
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, r))
                                .astype(np.int32)).to(dev)
        prefill_ms[r] = time_ms(lambda: eng.compiled_for(r)(toks), 1)
    print("  prefill ms per rung (CUDA events): " + ", ".join(
        f"{r}: {ms:.3f}" for r, ms in prefill_ms.items()) + f"  [{card}]")
    prefill = eng.compiled_for(rungs[-1])
    pshares = device_shares(lambda: prefill(toks), "flash_decode", steps=2)
    if pshares["device_ms"] is not None:
        print(f"  prefill at rung {rungs[-1]}: {pshares['wall_ms']:.3f} ms, "
              f"device busy {pshares['device_ms']:.3f} ms "
              f"({pshares['busy_share']:.1%}) in "
              f"{pshares['device_events']:.0f} device events  [{card}]")
        for name, ms in pshares["top_ms"].items():
            print(f"    device {ms:.3f} ms per prefill: {name}  [{card}]")
    toks = torch.zeros((slots,), dtype=torch.int32, device=dev)
    decode = eng.compiled_for("decode")
    shares = device_shares(lambda: decode(eng.cache, toks), "flash_decode")
    b5_ms = shares["kernel_ms"]
    shown = ("no device time in the trace" if b5_ms is None else
             f"device busy {shares['device_ms']:.3f} ms "
             f"({shares['busy_share']:.1%}) in "
             f"{shares['device_events']:.0f} device events, flash_decode "
             f"{b5_ms:.3f} ms ({shares['kernel_share']:.1%} of the step)")
    print(f"  one decode step on the live cache: {shares['wall_ms']:.3f} ms "
          f"(CUDA events); torch.profiler: {shown}  [{card}]")
    for name, ms in shares["top_ms"].items():
        print(f"    device {ms:.3f} ms per step: {name}  [{card}]")
    with HeldB5() as b5_held:
        decode(eng.cache, toks)
    live_b5 = b5_held.check("h2o-danube-1.8b: one decode step on the "
                            "live cache after the drain")
    lay = FDK.plan(slots, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                   cfg.head_dim_, max_seq, 2)
    out["danube"] = {
        "slots": slots, "max_seq": max_seq, "requests": n_req,
        "max_new": max_new, "decode_steps": report["steps"],
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "decode_tokens_per_s": dec_tokens / sum(step_s),
        "decode_p50_ms": p50, "decode_p99_ms": p99,
        "decode_bound_ms": bound_ms, "decode_bound_bytes": nbytes,
        "p50_over_bound": p50 / bound_ms, "prefill_ms": prefill_ms,
        "held_gib": held / 2**30, "peak_gib": peak / 2**30,
        "init_s": t_init, "warm_s": t_warm, "warm_b5_launches": warm_launches,
        "step_profile": shares, "live_cache_b5": live_b5,
        "prefill_profile": {"rung": rungs[-1], **pshares},
        "b5_plan": {"partitions": lay.n_parts, "partition_keys": lay.part_len,
                    "stages": lay.stages, "path": lay.path,
                    "blocks": lay.blocks}}
    del eng, decode, prefill
    torch.cuda.empty_cache()

    # -- 7b. decode against prefill, inside the window ---------------------
    print("== 7b. decode (B5) vs teacher-forced forward, 4 prompts of "
          "200-1000 tokens, 24 tokens each")
    out["decode_vs_prefill"] = {}
    for dtype, tol in (("float32", TOL_LM_FP32), ("bfloat16", TOL_LM_BF16)):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        eng = lm_engine(params, c, dev, record=True, slots=4, max_seq=1024)
        for p in lm_prompts(np.random.RandomState(1), c.vocab_size, 4, 200,
                            1000):
            eng.submit(p, 24)
        zero_counts(kernels)
        with HeldB5() as b5_held:
            report = eng.run()
        launches, others = launches_of(f"decode_vs_prefill_{dtype}")
        label = f"h2o-danube-1.8b {dtype} in the window"
        served_checks(label, eng, report, 4, 24, launches, others,
                      c.n_layers)
        out["decode_vs_prefill"][dtype] = {
            **decode_vs_forward(label, eng, c, report, tol),
            **b5_held.check(label)}
        del eng
        torch.cuda.empty_cache()

    # -- 7c. past the window: the ring wraps --------------------------------
    print("== 7c. past the window: 2 prompts of 4000 tokens, 160 new (the "
          "4096-slot ring wraps by 63)")
    out["past_window"] = {}
    for dtype, tol in (("float32", TOL_LM_FP32), ("bfloat16", TOL_LM_BF16)):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        eng = lm_engine(params, c, dev, record=True, slots=2,
                        max_seq=max_seq)
        rng = np.random.RandomState(2)
        for _ in range(2):
            eng.submit(rng.randint(0, c.vocab_size, 4000), 160)
        zero_counts(kernels)
        with HeldB5() as b5_held:
            report = eng.run()
        launches, others = launches_of(f"past_window_{dtype}")
        label = f"h2o-danube-1.8b {dtype} past the window"
        served_checks(label, eng, report, 2, 160, launches, others,
                      c.n_layers)
        wraps = int((eng.cache["pos"] - max_seq).clamp_min(0).max())
        check(wraps > 0, f"{label}: the ring wrapped ({wraps} slots "
                         f"rewritten)")
        out["past_window"][dtype] = {
            **decode_vs_forward(label, eng, c, report, tol),
            **b5_held.check(label)}
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    # -- 7d. minicpm-2b at full width: MHA, B5's CUDA-core path -------------
    print("== 7d. minicpm-2b served at full width (MHA, G=1: B5's CUDA-core "
          "path; tied head, padded vocab)")
    cfg = get_arch("minicpm-2b").model
    params = tfm.init(0, cfg, device=dev)
    slots, max_seq, n_req, max_new = 16, 1024, 32, 16
    eng = lm_engine(params, cfg, dev, slots=slots, max_seq=max_seq)
    eng.warm()
    eng.finite.clear()
    for p in lm_prompts(np.random.RandomState(3), cfg.vocab_size, n_req, 64,
                        512):
        eng.submit(p, max_new)
    zero_counts(kernels)
    report = eng.run()
    wall, step_s = report["wall_s"], report["decode_step_s"]
    launches, others = launches_of("minicpm_serving")
    served_checks("minicpm-2b slots=16", eng, report, n_req, max_new,
                  launches, others, cfg.n_layers)
    lay = FDK.plan(slots, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                   cfg.head_dim_, max_seq, 2)
    check(not lay.mma and "lm_head" not in params
          and params["embed"]["w"].shape[0] == 122880,
          f"minicpm-2b: B5 {lay.path} path ({lay.n_parts} partitions of "
          f"{lay.part_len} keys, {lay.blocks} blocks), tied head, padded "
          f"vocab {params['embed']['w'].shape[0]}")
    tokens = eng.metrics.counter("tokens_emitted")
    p50 = float(np.percentile(step_s, 50)) * 1e3
    flops, nbytes = H100Model.lm_decode_step(cfg, slots, max_seq)
    bound_ms = max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BPS) * 1e3
    print(f"  {n_req} requests, {report['steps']} decode steps, {tokens} "
          f"tokens in {wall:.3f} s: {tokens / wall:,.1f} tokens/s; decode "
          f"step p50 {p50:.3f} ms, bound {bound_ms:.3f} ms "
          f"({nbytes / 1e9:.3f} GB)  [{card}]")
    toks = torch.zeros((slots,), dtype=torch.int32, device=dev)
    decode = eng.compiled_for("decode")
    shares = device_shares(lambda: decode(eng.cache, toks), "flash_decode")
    if shares["device_ms"] is not None:
        print(f"  one decode step: {shares['wall_ms']:.3f} ms, device busy "
              f"{shares['device_ms']:.3f} ms ({shares['busy_share']:.1%}) in "
              f"{shares['device_events']:.0f} device events, flash_decode "
              f"{shares['kernel_ms']:.3f} ms ({shares['kernel_share']:.1%})"
              f"  [{card}]")
    # B5's bf16 G=1, D=64 instance first runs on a main path here: hold
    # each of a step's 40 launches on the live cache against the plain
    # version at 7d's own shape.
    with HeldB5() as b5_held:
        decode(eng.cache, toks)
    live_b5 = b5_held.check("minicpm-2b: one decode step on the live "
                            "cache after the drain")
    out["minicpm"] = {"slots": slots, "max_seq": max_seq, "requests": n_req,
                      "decode_steps": report["steps"], "tokens": tokens,
                      "wall_s": wall, "tokens_per_s": tokens / wall,
                      "decode_p50_ms": p50, "decode_bound_ms": bound_ms,
                      "b5_path": lay.path, "step_profile": shares,
                      "live_cache_b5": live_b5}
    del eng, params, decode
    torch.cuda.empty_cache()
    print("  phi3-medium-14b is not run: its 56 GB of fp32 params and a "
          "28 GB bf16 copy exceed the card's 80 GB")

    # -- 7e. the CLI, as a user starts it: danube at full width, defaults ---
    print("== 7e. python -m repro_torch.launch.serve --arch h2o-danube-1.8b")
    from repro_torch.launch import serve
    zero_counts(kernels)
    with HeldB5() as b5_held:
        report = serve.main(["--arch", "h2o-danube-1.8b"])
    launches, others = launches_of("serve_cli")
    layers = get_arch("h2o-danube-1.8b").model.n_layers
    check(len(report["done"]) == 8 and not report["shed"]
          and launches == layers * report["steps"] and not others,
          f"serve CLI on the card: {len(report['done'])} requests done, "
          f"{launches} flash_decode launches for {report['steps']} decode "
          f"steps of {layers} layers")
    out["serve_cli"] = b5_held.check("serve CLI on the card")
    torch.cuda.empty_cache()
    return out


# ---- phase 8: MoE LM serving --------------------------------------------------

#: 8a, each layer's ``moe_apply`` at the served capacity (drops included)
#: against a plain per-expert loop on the same x, expert ids and gates, on
#: results scaled to max(1, max |out|).  Both take every product in bf16
#: with fp32 sums and one rounding, but at other row counts (cuBLAS sums
#: in another order) and the loop adds a token's gated rows in expert
#: order where the layer adds them in k order, so a value may land one
#: bf16 rounding (2^-8 of it) apart at each of the gate / up / down
#: products and at the final cast: a few bf16 ulps of scale, 2^-6 with
#: room.  A wrong slot, position, drop or gate moves a token's row by
#: O(1) of its size.
TOL_MOE_BF16 = 2.0 ** -6


def plain_moe(params, moe, x, ids, gates, cdt, activation):
    """tests/test_moe.py's ``dense_moe_reference`` in torch on the card:
    for each expert in turn, its first ``capacity`` assignments in
    priority order ((token, k) order, as the stable sort keeps them),
    the SwiGLU of those tokens' rows, weighted by their gates and added
    into an fp32 output.  Returns (out in ``cdt``, kept assignments)."""
    from repro_torch.models.moe import capacity
    from repro_torch.nn.core import ACTIVATIONS
    t, d = x.shape
    k, c = moe.top_k, capacity(t, moe)
    act = ACTIVATIONS[activation]
    xc = x.to(cdt)
    w = params["experts"]
    flat, g = ids.reshape(-1), gates.reshape(-1)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    kept = 0
    for ex in range(moe.n_experts):
        hit = flat == ex
        take = torch.nonzero(hit & (torch.cumsum(hit, 0) <= c))[:, 0]
        if take.numel() == 0:
            continue
        tok = take // k
        xs = xc[tok]
        mid = act(xs @ w["w_gate"][ex].to(cdt)) * (xs @ w["w_in"][ex].to(cdt))
        y = mid @ w["w_out"][ex].to(cdt)
        out.index_add_(0, tok, (y * g[take].to(y.dtype)[:, None]).float())
        kept += take.numel()
    return out.to(cdt), kept


class HeldMoE:
    """Inside ``with``, every ``moe_apply`` the model makes is held
    against :func:`plain_moe` on the same x, with the expert ids and
    gates of ``moe.route`` on that x (the layer's own routing, so the
    check is of the dispatch: sort, position, capacity, scatter, gather
    and combine).  ``models/transformer.py`` calls ``moe_apply`` through
    its module, so this object stands in there; the model goes on with
    the layer's own output.  Also counts the assignments the capacity
    dropped, from the router's ids."""

    def __init__(self):
        from repro_torch.models import moe
        self._moe, self._apply = moe, moe.moe_apply
        self.errs, self.assigned, self.kept, self.calls = [], 0, 0, []

    def __call__(self, params, moe, x, *, compute_dtype, activation="silu"):
        out, aux = self._apply(params, moe, x, compute_dtype=compute_dtype,
                               activation=activation)
        _, gates, ids = self._moe.route(params, moe, x,
                                        compute_dtype=compute_dtype)
        ref, kept = plain_moe(params, moe, x, ids, gates, compute_dtype,
                              activation)
        self.errs.append(float((out.float() - ref.float()).abs().max())
                         / max(1.0, float(ref.float().abs().max())))
        self.assigned += ids.numel()
        self.kept += kept
        self.calls.append((x.shape[0], self._moe.capacity(x.shape[0], moe)))
        return out, aux

    def __enter__(self):
        self._moe.moe_apply = self
        return self

    def __exit__(self, *exc):
        self._moe.moe_apply = self._apply

    def check(self, label: str) -> dict:
        worst = max(self.errs) if self.errs else math.inf
        dropped = 1.0 - self.kept / max(self.assigned, 1)
        t, c = self.calls[0] if self.calls else (0, 0)
        check(worst <= TOL_MOE_BF16,
              f"{label}: each of {len(self.errs)} layers' moe_apply (T={t} "
              f"tokens, capacity {c}) vs a plain per-expert loop on the same "
              f"x, ids and gates: max|err| {worst:.3e} of max(1, |out|) (tol "
              f"{TOL_MOE_BF16:g}); {dropped:.2%} of {self.assigned} "
              f"assignments dropped")
        return {"layers_held": len(self.errs), "tokens": t, "capacity": c,
                "moe_vs_plain_of_scale": worst,
                "assignments": self.assigned, "dropped_share": dropped}


#: 8b, a routing tie: a (token, layer) whose k-th and (k+1)-th router
#: probabilities lie within this fraction of the k-th.  Decode (T = slots
#: rows a product) and the teacher-forced forward (T = S) sum their
#: products in other orders, so in fp32 their hidden states differ by
#: ~1e-5 of their size (phase 7b's fp32 gap, PERF.md §6): where a top-k
#: margin is thinner than that, the two runs may pick other experts,
#: which moves that token's output by O(1) and, through its K/V, later
#: positions by far more than the fp32 bar, as it would move between two
#: runs of the reference.
TIE_GAP = 1e-3


class RouteLog:
    """Inside ``with``, records the expert ids (T, k) that each
    ``moe_apply`` call routes to (``moe.route`` on the call's own x, on
    the host); the call itself runs as it would."""

    def __init__(self):
        from repro_torch.models import moe
        self._moe, self._apply = moe, moe.moe_apply
        self.calls = []

    def __call__(self, params, moe, x, *, compute_dtype, activation="silu"):
        ids = self._moe.route(params, moe, x, compute_dtype=compute_dtype)[2]
        self.calls.append(ids.cpu())
        return self._apply(params, moe, x, compute_dtype=compute_dtype,
                           activation=activation)

    def __enter__(self):
        self._moe.moe_apply = self
        return self

    def __exit__(self, *exc):
        self._moe.moe_apply = self._apply


class ForcedRoute:
    """Inside ``with``, the i-th ``moe.route`` call routes to the expert
    ids ``forced[i]``, with gates from that call's own router
    probabilities at those ids (renormalised, as ``route`` does), so a
    forward takes the routing a served run took and is compared with it
    on everything else: attention, cache, positions and the MoE's
    dispatch, all of which still run.  Counts the (token, layer) pairs
    whose forced experts differ from the call's own top-k, with the
    call's top-k margin at each."""

    def __init__(self, forced):
        from repro_torch.models import moe
        self._moe, self._route = moe, moe.route
        self.forced, self.calls, self.margins = forced, 0, []

    def __call__(self, params, moe, x, *, compute_dtype):
        probs, _, own = self._route(params, moe, x,
                                    compute_dtype=compute_dtype)
        ids = self.forced[self.calls].to(x.device)
        self.calls += 1
        gates = probs.gather(1, ids)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        differ = (own.sort(-1).values != ids.sort(-1).values).any(-1)
        top = probs.topk(moe.top_k + 1, dim=-1).values
        margin = (top[:, -2] - top[:, -1]) / top[:, -2]
        self.margins += margin[differ].tolist()
        return probs, gates, ids

    def __enter__(self):
        self._moe.route = self
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def moe_decode_vs_forward(label, eng, cfg, report, tol: float,
                          log: RouteLog) -> dict:
    """:func:`decode_vs_forward` for an MoE LM whose requests were all
    admitted before the first decode step (as many requests as slots):
    each request's teacher-forced forward takes the routing its served
    run took, token by token and layer by layer (``log``: the prefill's
    rows for the prompt, then one decode step's row per generated token;
    :class:`ForcedRoute`), and is held against the decode logits at
    ``tol``.  Wherever that routing differs from the forward's own top-k,
    the forward's margin there must be a tie (below ``TIE_GAP``): a
    served run whose hidden state went wrong would route off a tie."""
    from repro_torch.models import transformer as tfm
    params = eng.workload.compute_params()
    dec = torch.stack(eng.decode_logits)            # (steps, slots, V)
    n, layers = eng.slots, cfg.n_layers
    prefill, decode = log.calls[:n * layers], log.calls[n * layers:]
    worst, flips, clear, rows, routed, margins = 0.0, 0, 0, 0, 0, []
    for slot, r in enumerate(report["done"]):       # rid s sat in slot s
        pl, m = len(r.prompt), len(r.out)
        forced = [torch.cat([prefill[slot * layers + i][:pl],
                             torch.stack([decode[j * layers + i][slot]
                                          for j in range(m - 1)])])
                  for i in range(layers)]
        toks = torch.from_numpy(np.concatenate(
            [r.prompt, r.out[:-1]]).astype(np.int32))[None].to(eng.device)
        with ForcedRoute(forced) as fr, tfm.xla_rounding():
            want = tfm.forward(params, cfg, toks)[0][0, pl:].float()
        err, f, c = logit_gap(dec[:m - 1, slot], want, tol)
        worst, flips, clear, rows = max(worst, err), flips + f, clear + c, \
            rows + m - 1
        routed += (pl + m - 1) * layers
        margins += fr.margins
        del want
    check(len(decode) == report["steps"] * layers
          and all(g < TIE_GAP for g in margins),
          f"{label}: {len(margins)} of {routed} (token, layer) routings of "
          f"the served run differ from the forward's own top-k, each at a "
          f"tie (margins {', '.join(f'{g:.1e}' for g in margins) or 'none'};"
          f" bar {TIE_GAP:g})")
    check(worst <= tol and flips == 0,
          f"{label}: decode (B5) vs teacher-forced forward on the served "
          f"routing over {rows} positions: max|err| {worst:.3e} of scale "
          f"(tol {tol:g}); argmax flips {flips} of {clear} positions whose "
          f"top two lie > tol apart")
    return {"max_err_of_scale": worst, "positions": rows,
            "routings": routed, "routings_at_ties": len(margins),
            "tie_margins": margins, "clear_positions": clear,
            "argmax_flips": flips}


def moe_serving(dev, card: str, kernels, b5: Kernel) -> dict:
    """Phase 8: moonshot-v1-16b-a3b served at full width through
    ``LMEngine``, its decode attention on B5 (G = 1, D = 128), its MoE
    in plain PyTorch as the reference's is plain XLA.  Returns the
    phase's numbers, with B5's launches by run under ``b5_launches``."""
    from repro_torch.common.tree import param_bytes, param_count
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.codesign import H100Model, H100_BF16_FLOPS, \
        H100_HBM_BPS
    from repro_torch.kernels.flash_decode import kernel as FDK
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm

    out = {"b5_launches": {}}
    base = torch.cuda.memory_allocated()

    def launches_of(run: str) -> tuple[int, dict]:
        others = {k.name: k.counter.launches for k in kernels
                  if k is not b5 and k.counter.launches}
        out["b5_launches"][run] = b5.counter.launches
        return b5.counter.launches, others

    # -- 8a. moonshot-v1-16b-a3b at full width, 16 slots --------------------
    print("== 8a. moonshot-v1-16b-a3b served at full width (LMEngine; MoE "
          "64 experts top-6; B5 at G=1, D=128)")
    full = get_arch("moonshot-v1-16b-a3b").model
    # fp32 params would be 112 GB: bf16 params, the same values the
    # engine's one cast to the compute dtype would make (the memory plan
    # configs/arctic_480b.py uses)
    cfg = dataclasses.replace(full, param_dtype="bfloat16")
    slots, max_seq, n_req, max_new = 16, 2048, 48, 32
    t0 = time.perf_counter()
    params = tfm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    torch.cuda.empty_cache()              # the init's fp32 temporaries
    n_params = param_count(params)
    check(n_params == 28_057_995_264 and all(
        t.dtype == torch.bfloat16 for t in params["layers"]["moe"]
        ["experts"].values()),
        f"moonshot-v1-16b-a3b: {n_params:,} params in bf16 "
        f"({param_bytes(params) / 1e9:.2f} GB), drawn on the card in "
        f"{t_init:.2f} s")
    eng = lm_engine(params, cfg, dev, slots=slots, max_seq=max_seq)
    zero_counts(kernels)
    t0 = time.perf_counter()
    eng.warm()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm_launches = b5.counter.launches
    eng.finite.clear()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() - base
    prompts = lm_prompts(np.random.RandomState(8), cfg.vocab_size, n_req, 64,
                         1024)
    for p in prompts:
        eng.submit(p, max_new)
    zero_counts(kernels)
    report = eng.run()
    wall, step_s = report["wall_s"], report["decode_step_s"]
    launches, others = launches_of("moonshot_serving")
    peak = torch.cuda.max_memory_allocated() - base
    served_checks("moonshot-v1-16b-a3b slots=16", eng, report, n_req,
                  max_new, launches, others, cfg.n_layers)
    rungs = sorted({eng.bucket_for(len(p)) for p in prompts})
    tokens = eng.metrics.counter("tokens_emitted")
    dec_tokens = tokens - n_req
    p50, p99 = (float(np.percentile(step_s, q)) * 1e3 for q in (50, 99))
    flops, nbytes = H100Model.lm_decode_step(cfg, slots, max_seq)
    bound_ms = max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BPS) * 1e3
    print(f"  init {t_init:.2f} s, warm {t_warm:.2f} s "
          f"({len(eng.bucket_sizes)} prefill rungs + decode, {warm_launches} "
          f"flash_decode launches, counted apart)  [{card}]")
    print(f"  {n_req} requests, {report['steps']} decode steps, {tokens} "
          f"tokens in {wall:.3f} s: {tokens / wall:,.1f} tokens/s "
          f"({dec_tokens / sum(step_s):,.1f} decode tokens/s over the "
          f"steps)  [{card}]")
    print(f"  decode step ({slots} slots, T={max_seq}): p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms; bound {bound_ms:.3f} ms ({nbytes / 1e9:.3f} "
          f"GB: bf16 weights, all 64 experts' three matrices a layer, and "
          f"K/V over all T slots, at 3.35 TB/s; {flops / 1e12:.3f} TFLOP at "
          f"989 TFLOP/s); p50 / bound {p50 / bound_ms:.2f}  [{card}]")
    print(f"  device memory above the {base / 2**30:.2f} GiB earlier phases "
          f"hold: {held / 2**30:.2f} GiB before the run (bf16 params, the "
          f"cache), peak {peak / 2**30:.2f} GiB  [{card}]")
    rng = np.random.RandomState(9)
    prefill_ms = {}
    for r in rungs:
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, r))
                                .astype(np.int32)).to(dev)
        prefill_ms[r] = time_ms(lambda: eng.compiled_for(r)(toks), 1)
    print("  prefill ms per rung (CUDA events): " + ", ".join(
        f"{r}: {ms:.3f}" for r, ms in prefill_ms.items()) + f"  [{card}]")
    last = ([0] * slots + [r.out[-1] for r in report["done"]])[-slots:]
    toks = torch.tensor(last, dtype=torch.int32, device=dev)
    decode = eng.compiled_for("decode")
    shares = device_shares(lambda: decode(eng.cache, toks), "flash_decode")
    b5_ms = shares["kernel_ms"]
    shown = ("no device time in the trace" if b5_ms is None else
             f"device busy {shares['device_ms']:.3f} ms "
             f"({shares['busy_share']:.1%}) in "
             f"{shares['device_events']:.0f} device events, flash_decode "
             f"{b5_ms:.3f} ms ({shares['kernel_share']:.1%} of the step)")
    print(f"  one decode step on the live cache: {shares['wall_ms']:.3f} ms "
          f"(CUDA events); torch.profiler: {shown}  [{card}]")
    for name, ms in shares["top_ms"].items():
        print(f"    device {ms:.3f} ms per step: {name}  [{card}]")
    # one decode step (the drain's last tokens) and one prefill (a 1,000-
    # token prompt padded to the 1,024 rung, as _admit pads it), each B5
    # launch and each layer's MoE held against its plain version
    with HeldB5() as b5_held, HeldMoE() as moe_held:
        decode(eng.cache, toks)
    live_b5 = b5_held.check("moonshot-v1-16b-a3b: one decode step on the "
                            "live cache after the drain")
    moe_decode = moe_held.check("moonshot-v1-16b-a3b: one decode step")
    padded = np.zeros((1, 1024), np.int32)
    padded[0, :1000] = rng.randint(0, cfg.vocab_size, 1000)
    with HeldMoE() as moe_held:
        eng.compiled_for(1024)(torch.from_numpy(padded).to(dev))
    moe_prefill = moe_held.check("moonshot-v1-16b-a3b: one prefill of 1,000 "
                                 "tokens at the 1,024 rung")
    lay = FDK.plan(slots, cfg.n_kv_heads, 1, cfg.head_dim_, max_seq, 2)
    check(not lay.mma, f"moonshot-v1-16b-a3b: B5 {lay.path} path "
                       f"({lay.n_parts} partitions of {lay.part_len} keys, "
                       f"{lay.blocks} blocks)")
    out["moonshot"] = {
        "slots": slots, "max_seq": max_seq, "requests": n_req,
        "max_new": max_new, "params": n_params,
        "decode_steps": report["steps"], "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "decode_tokens_per_s": dec_tokens / sum(step_s),
        "decode_p50_ms": p50, "decode_p99_ms": p99,
        "decode_bound_ms": bound_ms, "decode_bound_bytes": nbytes,
        "p50_over_bound": p50 / bound_ms, "prefill_ms": prefill_ms,
        "held_gib": held / 2**30, "peak_gib": peak / 2**30,
        "init_s": t_init, "warm_s": t_warm, "warm_b5_launches": warm_launches,
        "step_profile": shares, "live_cache_b5": live_b5,
        "held_moe_decode": moe_decode, "held_moe_prefill": moe_prefill,
        "b5_plan": {"partitions": lay.n_parts, "partition_keys": lay.part_len,
                    "stages": lay.stages, "path": lay.path,
                    "blocks": lay.blocks}}
    del eng, decode, params
    torch.cuda.empty_cache()

    # -- 8b. decode vs teacher-forced forward, fp32, 4 layers, no drops ----
    # The bf16 full-depth decode-vs-forward check is left out: the two runs
    # route T = slots and T = S tokens, so their capacities and drops
    # differ, and their bf16 residual streams drift ~1e-2 apart, enough to
    # swap a token's 6th and 7th expert where they lie close, which moves
    # that token's output by O(1).  fp32 at full width with a capacity
    # factor of E / k (so c >= T: nothing drops in either run) holds the
    # cache, positions and dispatch end to end instead.
    moe = dataclasses.replace(full.moe, capacity_factor=full.moe.n_experts
                              / full.moe.top_k)
    c4 = dataclasses.replace(full, n_layers=4, compute_dtype="float32",
                             moe=moe)
    print("== 8b. moonshot-v1-16b-a3b at full width, 4 layers, fp32, "
          f"capacity factor {moe.capacity_factor:.4f} (no drops): decode "
          "(B5) vs teacher-forced forward")
    params = tfm.init(0, c4, device=dev)
    out["decode_vs_forward"] = {"layers": 4,
                                "params": param_count(params)}
    runs = (("in the cache", 4, 1024, 200, 1000, 24, c4),
            # past the ring: full attention over the last 1,024 positions,
            # what a forward with a window of 1,024 computes
            ("past the ring", 2, 1024, 1000, 1000, 64,
             dataclasses.replace(c4, sliding_window=1024)))
    for i, (what, n, seq, lo, hi, new, fwd_cfg) in enumerate(runs):
        eng = lm_engine(params, c4, dev, record=True, slots=n, max_seq=seq)
        ts = range(1, seq + new + 1)
        check(all(moe_lib.capacity(t, moe) >= t for t in ts),
              f"capacity >= T at every T up to {ts[-1]} (decode {n}, "
              f"prefill rungs, forward): no drops")
        for p in lm_prompts(np.random.RandomState(10 + i), c4.vocab_size, n,
                            lo, hi):
            eng.submit(p, new)
        zero_counts(kernels)
        with HeldB5() as b5_held, RouteLog() as routes:
            report = eng.run()
        key = what.replace(" ", "_")
        launches, others = launches_of(f"decode_vs_forward_{key}")
        label = f"moonshot-v1-16b-a3b 4 layers fp32 {what}"
        served_checks(label, eng, report, n, new, launches, others,
                      c4.n_layers)
        if fwd_cfg.sliding_window:
            wraps = int((eng.cache["pos"] - seq).clamp_min(0).max())
            check(wraps > 0, f"{label}: the ring wrapped ({wraps} slots "
                             f"rewritten)")
        out["decode_vs_forward"][key] = {
            **moe_decode_vs_forward(label, eng, fwd_cfg, report,
                                    TOL_LM_FP32, routes),
            **b5_held.check(label)}
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    # -- 8c. the CLI, as a user starts it --------------------------------
    print("== 8c. python -m repro_torch.launch.serve --arch "
          "moonshot-v1-16b-a3b")
    from repro_torch.launch import serve
    zero_counts(kernels)
    with HeldB5() as b5_held:
        report = serve.main(["--arch", "moonshot-v1-16b-a3b"])
    launches, others = launches_of("moonshot_serve_cli")
    check(len(report["done"]) == 8 and not report["shed"]
          and launches == full.n_layers * report["steps"] and not others,
          f"serve CLI on the card: {len(report['done'])} requests done, "
          f"{launches} flash_decode launches for {report['steps']} decode "
          f"steps of {full.n_layers} layers")
    out["serve_cli"] = b5_held.check("moonshot serve CLI on the card")
    torch.cuda.empty_cache()
    return out


# ---- phase 9: LM training -----------------------------------------------------

#: 9, the bar on the first loss: at init each logit is a sum over
#: d_model unit-RMS hidden values times N(0, 0.02^2) head weights, so the
#: logits spread with variance d_model * 4e-4 (~1) and the first loss
#: lies near ln(V) + var / 2 (+ the MoE's aux loss, ~0.01 a layer):
#: within 1.5 nats above ln(V).
LOSS_INIT_MARGIN = 1.5
#: 9, the fit: FIT_STEPS steps of the program's train step (its
#: optimizer and schedule from step 0) on one ``lm_batches`` batch must
#: lower that batch's loss by LOSS_FALL nats.  The stream shows no
#: learning in 50 steps of this recipe: its next tokens are uniform over
#: the vocab but for each token's 32 successors, a bigram seen ~3 times
#: per token in 50 batches of 2,048, while Adafactor moves every weight
#: by up to lr a step whatever its gradient's size (at the CLI's default
#: lr, 1e-3 after a 50-step warmup, danube's stream loss rises once the
#: warmup passes ~5e-4: PERF.md §6).  A fixed batch gives the step one
#: consistent gradient, so forward, backward and Adafactor's update must
#: lower it.
FIT_STEPS = 10
LOSS_FALL = 0.5


def lm_training(dev, card: str, kernels) -> dict:
    """Phase 9: the LMs trained through ``launch.train``'s ``lm``
    program (Adafactor, warmup-cosine, ``remat="layer"``, batch 8 x 256
    tokens of ``lm_batches``, the CLI's default lr): h2o-danube-1.8b at
    full width with its state through a checkpoint, then
    moonshot-v1-16b-a3b at full width cut to 4 layers (fp32 params),
    whose backward runs through the MoE's dispatch; then each fitted to
    one batch.  Returns the phase's numbers."""
    import importlib
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.common.tree import tree_leaves
    from repro_torch.launch import train as train_cli
    from repro_torch.training import init_state

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_train_")
    runs = (("h2o-danube-1.8b", "h2o_danube_1_8b", None, True),
            ("moonshot-v1-16b-a3b", "moonshot_v1_16b_a3b", 4, False))
    try:
        for arch_id, module, layers, ckpt in runs:
            mod = importlib.import_module(f"repro_torch.configs.{module}")
            arch = mod.ARCH
            cfg = arch.model if layers is None else dataclasses.replace(
                arch.model, n_layers=layers)
            cut = "" if layers is None else f", cut to {layers} layers"
            print(f"== 9. train {arch_id} at full width{cut} (lm program: "
                  f"Adafactor, remat={cfg.remat}, batch 8 x 256)")
            mod.ARCH = dataclasses.replace(arch, model=cfg)
            try:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                argv = ["--arch", arch_id, "--device", str(dev), "--steps",
                        "50", "--batch", "8", "--log-every", "10"]
                if ckpt:
                    argv += ["--ckpt-dir", f"{tmp}/{module}",
                             "--ckpt-every", "1000"]
                zero_counts(kernels)
                res, _ = _run_main(argv)
                peak = torch.cuda.max_memory_allocated() - before
                hist = res["history"]
                first = hist[0][1]["loss"]
                ln_v = math.log(cfg.vocab_size)
                check(all(np.isfinite(m["loss"]) for _, m in hist)
                      and ln_v <= first <= ln_v + LOSS_INIT_MARGIN,
                      f"{arch_id}: loss {first:.4f} at step 0 (ln V = "
                      f"{ln_v:.4f}, bar +{LOSS_INIT_MARGIN}), finite to step"
                      f" {hist[-1][0]}: " + ", ".join(
                          f"{m['loss']:.4f}" for _, m in hist))
                check(sum(k.counter.launches for k in kernels) == 0,
                      f"{arch_id} training launched no hand-written kernel "
                      "(plain PyTorch forward and backward, as the "
                      "reference's XLA)")
                print(f"  {arch_id}: {res['ms_per_step']:.3f} ms/step over "
                      f"the loop ({1e3 / res['ms_per_step']:.3f} it/s, CUDA "
                      f"events), peak device memory {peak / 2**30:.2f} GiB "
                      f"above the {before / 2**30:.2f} GiB held before  "
                      f"[{card}]")
                row = {"layers": cfg.n_layers, "steps": res["steps"],
                       "batch": [8, 256], "lr": 1e-3,
                       "ms_per_step": res["ms_per_step"],
                       "peak_gib": peak / 2**30, "ln_vocab": ln_v,
                       "losses": {i: m["loss"] for i, m in hist}}
                if ckpt:
                    t0 = time.perf_counter()
                    state, step = CheckpointManager(
                        f"{tmp}/{module}").restore(device=dev)
                    t_restore = time.perf_counter() - t0
                    a, b = tree_leaves(state), tree_leaves(res["state"])
                    same = len(a) == len(b) and all(
                        torch.equal(x, y) for x, y in zip(a, b))
                    check(step == 50 and same,
                          f"{arch_id}: the final checkpoint restores step "
                          f"{step} bitwise ({len(a)} leaves: params, "
                          f"Adafactor's factored state, step) in "
                          f"{t_restore:.2f} s")
                    row["checkpoint_restore_s"] = t_restore
                    del state, a, b
                del res
                torch.cuda.empty_cache()
                # the fit: the program's step from the same init on one batch
                init_fn, step_fn, batches, opt = train_cli.make_program(
                    arch_id, 8, 1e-3, dev)
                state = init_state(0, init_fn, opt)
                batch = train_cli.to_device(next(batches), dev)
                fit = []
                for _ in range(FIT_STEPS):
                    state, m = step_fn(state, batch)
                    fit.append(m["loss"])
                fit = [float(v) for v in fit]
                check(fit[-1] <= fit[0] - LOSS_FALL,
                      f"{arch_id}: {FIT_STEPS} steps on one batch lower its "
                      f"loss from {fit[0]:.4f} to {fit[-1]:.4f} (bar: "
                      f"{LOSS_FALL} nats)")
                row["fit_losses"] = fit
                out[arch_id] = row
                del state, batch
            finally:
                mod.ARCH = arch
            torch.cuda.empty_cache()
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---- phase 10: the GNN zoo --------------------------------------------------

#: 10, the reference's loss of each arch's ``gnn`` program at step 0: its
#: ``_gnn_loss`` at ``init(PRNGKey(0))`` on the program's graph, from the
#: JAX package on a CPU (the card has no JAX), by
#:   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import sys, jax, jax.numpy as jnp
#:   from repro.configs.registry import get_arch
#:   from repro.launch import train as T
#:   from repro.launch.steps import _gnn_loss
#:   from repro.models.gnn import GNN_MODULES
#:   a = sys.argv[1]; cfg = get_arch(a).model; mod = GNN_MODULES[cfg.kind]
#:   init, _, batches, _ = T.make_program(a, 256, 1e-3)
#:   g = {k: jnp.asarray(v) for k, v in next(batches).items()}
#:   f = jax.jit(lambda p, g: _gnn_loss(cfg.kind, cfg, mod.apply(p, cfg, g), g)[0])
#:   print(repr(float(f(init(jax.random.PRNGKey(0)), g))))" ARCH
GNN_REF_LOSS = {"gcn-cora": 2.118002414703369, "pna": 102.55293273925781,
                "meshgraphnet": 15.880664825439453,
                "equiformer-v2": 2.0887057781219482}
#: 10, the reference train CLI's losses at the listed steps (its loop:
#: ``make_program(ARCH, 256, 1e-3)``, ``init_state(PRNGKey(0))``, the
#: jitted step on the same graph each step), from the JAX package on a
#: CPU by
#:   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import sys, jax, jax.numpy as jnp
#:   from repro.launch import train as T
#:   from repro.training import init_state
#:   init, step, batches, opt = T.make_program(sys.argv[1], 256, 1e-3)
#:   s = init_state(jax.random.PRNGKey(0), init, opt)
#:   g = {k: jnp.asarray(v) for k, v in next(batches).items()}
#:   f = jax.jit(step)
#:   for i in range(50):
#:       s, m = f(s, g); print(i, repr(float(m['loss'])))" ARCH
#: Held at GNN_TOL_AT up to GNN_HELD_TO, where the trajectory is
#: reproducible: gcn-cora's to step 49, pna's and meshgraphnet's to step 9.
#: Past that their loss swings from step to step and amplifies fp32
#: rounding: the port's program agrees with the reference's within 3e-7
#: of the loss over its first 4 steps from one state
#: (tests/test_torch_gnn_training.py), yet the port's CPU train CLI
#: (``OMP_NUM_THREADS=T python -m repro_torch.launch.train --device cpu
#: --arch A --steps 50``) ends pna at 2.528 with T = 3 and 2.575 with
#: T = 4 against the reference's 3.126, and meshgraphnet at 0.3124 and
#: 0.1386 against 0.2212: the thread count alone, which reorders the
#: BLAS sums, moves the step-49 loss by 2% and 2.3x (PERF.md §6).
#: Their step-49 losses are printed beside the reference's, and must lie
#: below step 0's.
GNN_REF_AT = {"gcn-cora": {9: 2.0942907333374023, 49: 1.4396681785583496},
              "pna": {9: 60.866615295410156, 49: 3.1257123947143555},
              "meshgraphnet": {9: 3.5207157135009766, 49: 0.221161887049675}}
GNN_HELD_TO = {"gcn-cora": 49, "pna": 9, "meshgraphnet": 9}
#: 10a, the step-0 loss against GNN_REF_LOSS (fp32 forward in another
#: sum order; the port's CPU run lands within 7.5e-8)
GNN_TOL_LOSS0 = 1e-4
#: 10a, the losses along the run against GNN_REF_AT: index_add's fp32
#: atomics reorder each step's sums on the card
GNN_TOL_AT = 1e-3
#: 10a-c, the card's forward against the port's on the CPU, of
#: max(1, max |out|): fp32, TF32 off, sums in other orders
GNN_TOL_CPU = 2e-4
#: 10b, equiformer-v2's readout under a rotation / a translation of pos:
#: the reference test's bars (tests/test_equiformer.py)
GNN_TOL_ROT, GNN_TOL_SHIFT = 5e-3, 5e-4
#: 10b, the chunked edge path against the direct one
GNN_TOL_CHUNK = 2e-4
#: 10, the archs of the ``gnn`` program and the widths they run at
GNN_ARCHS = ("gcn-cora", "pna", "meshgraphnet", "equiformer-v2")


def _gnn_forward_vs_cpu(label, mod, cfg, params_cpu, graph_cpu, dev):
    """The forward on the card against the port's on the CPU at the same
    weights: (card params, card graph, card output, relative error)."""
    from repro_torch.common.tree import tree_map
    with torch.no_grad():
        t0 = time.perf_counter()
        want = mod.apply(params_cpu, cfg, graph_cpu)
        cpu_s = time.perf_counter() - t0
        params = tree_map(lambda t: t.to(dev), params_cpu)
        graph = {k: v.to(dev) for k, v in graph_cpu.items()}
        got = mod.apply(params, cfg, graph)
        err, rel = err_of(got.cpu(), want)
    check(got.shape == want.shape and bool(torch.isfinite(got).all())
          and rel <= GNN_TOL_CPU,
          f"{label}: card forward {tuple(got.shape)} vs the port's CPU "
          f"forward (CPU {cpu_s:.1f} s): max|err| {err:.3e} ({rel:.2e} of "
          f"scale, tol {GNN_TOL_CPU:g})")
    return params, graph, got, rel


def _no_sync_step(label, loss_fn, params, graph) -> bool:
    """One forward and backward with CUDA's sync debug mode set to
    "error", after a warm one (which puts the SO(3) constants on the
    card): any read back to the host raises."""
    from repro_torch.common.tree import tree_leaves, tree_unflatten

    def fwd_bwd():
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        loss, _ = loss_fn(tree_unflatten(params, leaves), graph)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    fwd_bwd()
    torch.cuda.synchronize()
    err = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = fwd_bwd()
    except RuntimeError as e:
        err = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ok = err is None and all(g is None or bool(torch.isfinite(g).all())
                             for g in grads)
    return check(ok, f"{label}: one forward and backward read nothing back "
                 f"to the host (sync debug mode 'error'){': ' + err if err else ''}")


def gnn_zoo(dev, card: str, kernels) -> dict:
    """Phase 10: the GNN zoo trained through ``launch.train``'s ``gnn``
    program at full width (10a), equiformer-v2's invariances, chunked
    path and profile (10b), gcn-cora at ogb_products' size (10c).
    Returns the phase's numbers."""
    from repro_torch.common import prng
    from repro_torch.common.tree import param_count, tree_map
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.graphs import community_graph
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.steps import _gnn_loss
    from repro_torch.models.gnn import GNN_MODULES, so3
    from repro_torch.training import init_state, make_optimizer, \
        make_train_step
    from repro_torch.training.schedule import warmup_cosine

    out = {}
    cpu = torch.device("cpu")
    zero_counts(kernels)
    for arch_id in GNN_ARCHS:
        cfg = get_arch(arch_id).model
        mod = GNN_MODULES[cfg.kind]
        print(f"== 10a. train {arch_id} at full width ({cfg.n_layers} layers"
              f" x {cfg.d_hidden}; gnn program: AdamW, 4,096 nodes, 16,384 "
              "edges, 64 features)")

        def loss_fn(p, g, cfg=cfg, mod=mod):
            return _gnn_loss(cfg.kind, cfg, mod.apply(p, cfg, g), g)

        batches = train_cli.make_program(arch_id, 256, 1e-3, cpu)[2]
        graph_cpu = train_cli.to_device(next(batches), cpu)
        t0 = time.perf_counter()
        params_cpu = mod.init(prng.key(0), cfg, 64, cfg.n_classes,
                              device=cpu)
        init_s = time.perf_counter() - t0
        params, graph, _, rel = _gnn_forward_vs_cpu(
            arch_id, mod, cfg, params_cpu, graph_cpu, dev)
        del params_cpu
        no_sync = _no_sync_step(arch_id, loss_fn, params, graph)
        row = {"params": param_count(params), "init_replay_s": init_s,
               "forward_vs_cpu": rel, "no_host_sync": no_sync}
        if arch_id == "equiformer-v2":
            eq = (cfg, mod, params, graph, loss_fn)
        else:
            del params, graph
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res, _ = _run_main(["--arch", arch_id, "--device", str(dev),
                            "--steps", "50", "--log-every", "9"])
        peak = torch.cuda.max_memory_allocated() - before
        hist = {i: m for i, m in res["history"]}
        first, last = hist[0]["loss"], hist[49]["loss"]
        ref0 = GNN_REF_LOSS[arch_id]
        check(abs(first - ref0) <= GNN_TOL_LOSS0 * abs(ref0),
              f"{arch_id}: step-0 loss {first:.7g} vs the reference's "
              f"{ref0:.7g} ({abs(first - ref0) / abs(ref0):.2e} relative, "
              f"tol {GNN_TOL_LOSS0:g})")
        for step, ref in GNN_REF_AT.get(arch_id, {}).items():
            got = hist[step]["loss"]
            gap = abs(got - ref) / abs(ref)
            what = (f"{arch_id}: step-{step} loss {got:.7g} vs the reference "
                    f"CLI's {ref:.7g} ({gap:.2e} relative")
            if step <= GNN_HELD_TO[arch_id]:
                check(gap <= GNN_TOL_AT, f"{what}, tol {GNN_TOL_AT:g})")
            else:
                print(f"  {what}; not held: past step "
                      f"{GNN_HELD_TO[arch_id]} the trajectory amplifies fp32 "
                      "rounding)")
        check(all(np.isfinite(m["loss"]) for m in hist.values())
              and last < first,
              f"{arch_id}: losses finite and falling over the fixed graph: "
              + ", ".join(f"{i}: {m['loss']:.5g}" for i, m in hist.items()))
        metric = "accuracy" if "accuracy" in hist[0] else "mse"
        print(f"  {arch_id}: {row['params']:,} params (prng replay {init_s:.1f}"
              f" s), {res['ms_per_step']:.3f} ms/step over the loop (CUDA "
              f"events), peak device memory {peak / 2**30:.2f} GiB; {metric}"
              f" {hist[0][metric]:.4g} -> {hist[49][metric]:.4g}  [{card}]")
        row.update({"ms_per_step": res["ms_per_step"], "steps": res["steps"],
                    "peak_gib": peak / 2**30, "ref_loss_0": ref0,
                    "losses": {i: m["loss"] for i, m in hist.items()},
                    metric: {0: hist[0][metric], 49: hist[49][metric]}})
        out[arch_id] = row
        del res
        torch.cuda.empty_cache()

    # ---- 10b. equiformer-v2: invariances, chunked path, profile ----------
    cfg, mod, params, graph, loss_fn = eq
    print("== 10b. equiformer-v2 at full width: invariances, the chunked "
          "edge path, one profiled train step")
    with torch.no_grad():
        base = mod.apply(params, cfg, graph)
        rot = so3.rotation_matrices(torch.tensor([0.3, -1.1, 0.7],
                                                 device=dev))
        _, rel_rot = err_of(mod.apply(params, cfg, dict(
            graph, pos=graph["pos"] @ rot.T)), base)
        shift = torch.tensor([10.0, -3.0, 2.0], device=dev)
        _, rel_shift = err_of(mod.apply(params, cfg, dict(
            graph, pos=graph["pos"] + shift)), base)
        chunk = 4096
        _, rel_chunk = err_of(mod.apply(params, dataclasses.replace(
            cfg, edge_chunk=chunk), graph), base)
    n_edges = graph["senders"].shape[0]
    check(rel_rot <= GNN_TOL_ROT, f"equiformer-v2: readout under a rotation"
          f" of pos moves {rel_rot:.2e} of scale (tol {GNN_TOL_ROT:g})")
    check(rel_shift <= GNN_TOL_SHIFT, f"equiformer-v2: readout under a "
          f"translation of pos moves {rel_shift:.2e} of scale (tol "
          f"{GNN_TOL_SHIFT:g})")
    check(rel_chunk <= GNN_TOL_CHUNK, f"equiformer-v2: edge_chunk {chunk} "
          f"({-(-n_edges // chunk)} chunks of {n_edges} edges) vs the direct"
          f" path: {rel_chunk:.2e} of scale (tol {GNN_TOL_CHUNK:g})")
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 50, 5000))
    state = init_state(0, lambda _: params, opt)
    step_fn = make_train_step(loss_fn, opt)
    prof = device_shares(lambda: step_fn(state, graph), "index", steps=1,
                         top=8)
    busy = prof["busy_share"]
    print(f"  equiformer-v2 train step: wall {prof['wall_ms']:.3f} ms, device"
          f" busy {'not measured' if busy is None else f'{busy:.1%}'}, "
          f"{prof['device_events']} device events; gathers and scatters "
          f"(index kernels) {prof['kernel_ms']} ms  [{card}]")
    for name, ms in prof["top_ms"].items():
        print(f"    {ms:9.3f} ms  {name}")
    out["equiformer-v2"].update({
        "rotation_rel": rel_rot, "translation_rel": rel_shift,
        "chunked_rel": rel_chunk, "chunk": chunk, "profile": prof})
    del eq, params, graph, state, step_fn, base
    torch.cuda.empty_cache()

    # ---- 10c. gcn-cora at ogb_products' size -----------------------------
    shape = GNN_SHAPES["ogb_products"]
    n, e, d = (shape.dim(k) for k in ("n_nodes", "n_edges", "d_feat"))
    cfg = get_arch("gcn-cora").model
    mod = GNN_MODULES[cfg.kind]
    print(f"== 10c. gcn-cora at ogb_products' size ({n:,} nodes, {e:,} edges,"
          f" {d} features) on one card")
    t0 = time.perf_counter()
    g = community_graph(0, n, e, d, n_classes=cfg.n_classes)
    gen_s = time.perf_counter() - t0
    graph_cpu = train_cli.to_device(g, cpu)
    params_cpu = mod.init(prng.key(0), cfg, d, cfg.n_classes, device=cpu)
    params, graph, _, rel = _gnn_forward_vs_cpu(
        "gcn-cora ogb_products", mod, cfg, params_cpu, graph_cpu, dev)
    del graph_cpu, params_cpu, g

    def loss_fn(p, g):
        return _gnn_loss(cfg.kind, cfg, mod.apply(p, cfg, g), g)

    opt = make_optimizer("adamw", warmup_cosine(1e-3, 50, 5000))
    state = init_state(0, lambda _: tree_map(lambda t: t.clone(), params),
                       opt)
    step_fn = make_train_step(loss_fn, opt)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    losses, times = [], []
    for _ in range(6):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        state, m = step_fn(state, graph)
        t1.record()
        losses.append(m["loss"])
        times.append((t0, t1))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    step_ms = sorted(a.elapsed_time(b) for a, b in times[1:])
    losses = [float(v) for v in losses]
    ms = step_ms[len(step_ms) // 2]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "gcn-cora ogb_products: 6 train steps, losses " + ", ".join(
              f"{v:.5g}" for v in losses))
    print(f"  gcn-cora ogb_products: graph made in {gen_s:.1f} s on the host;"
          f" {ms:.3f} ms/step (median of steps 1-5, CUDA events; {step_ms[0]:.3f}"
          f"-{step_ms[-1]:.3f}), peak device memory {peak / 2**30:.2f} GiB "
          f"above the {before / 2**30:.2f} GiB held (graph and state)  "
          f"[{card}]")
    out["gcn-cora ogb_products"] = {
        "nodes": n, "edges": e, "d_feat": d, "graph_gen_s": gen_s,
        "forward_vs_cpu": rel, "ms_per_step": ms, "step_ms": step_ms,
        "peak_gib": peak / 2**30, "held_gib": before / 2**30,
        "losses": losses}
    del params, graph, state, step_fn
    torch.cuda.empty_cache()
    launched = {k.name: k.counter.launches for k in kernels}
    check(sum(launched.values()) == 0,
          f"phase 10 launched no hand-written kernel: {launched}")
    return out


# ---- phase 11: multi-device --------------------------------------------------

#: 11a: a sharded step against the unsharded one on the same card, at the
#: reference's bar (tests/test_multidevice.py), of scale (at least 1).
TOL_SHARDED = 1e-4
#: 11b: a2a_moe against the global moe_apply with ample capacity, of scale.
TOL_A2A = 1e-5
#: 11a's sizes: jedinet-30p's batch and AdamW steps (the first, which
#: fills DTensor's sharding caches, is not timed); danube's cut and batch.
MD_JEDI_BATCH, MD_JEDI_STEPS = 1024, 5
MD_LM_LAYERS, MD_LM_BATCH, MD_LM_SEQ = 2, 2, 256
#: 11b: one moonshot-v1-16b-a3b MoE layer's tokens; 11c: served batches.
MD_MOE_TOKENS, MD_STREAM = 1024, 40


def _wall_ms(fn, dev, reps: int = 3) -> float:
    """ms per call of ``fn()`` on the host clock around ``reps`` calls
    that end in a synchronise (after one warm-up call): the collectives
    and DTensor's dispatch run on the host."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def _tree_err(got, want) -> float:
    """Max |got - want| over the leaves, over the largest |want| (>= 1)."""
    from repro_torch.common.tree import tree_leaves
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(tree_leaves(got), tree_leaves(want)))
    scale = max([1.0] + [float(w.float().abs().max())
                         for w in tree_leaves(want)])
    return err / scale


def multidevice(dev, card: str, kernels, b1: Kernel) -> dict:
    """Phase 11: the multi-device layer on a world-size-1 NCCL group over
    the card (``gloo`` on the CPU): sharded train steps on a (1, 1)
    ``("data", "model")`` DeviceMesh (11a), the int8 error-feedback
    all-reduce and the all-to-all MoE dispatch (11b), the data-parallel
    trigger engine with two shards on the card (11c) and elastic restore
    onto a 1-D mesh (11d).  Returns B1's 11c launches (counts set to 0
    just before each engine's run and read just after) and the phase's
    numbers.  The group is destroyed on the way out, on failure too."""
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.configs import h2o_danube_1_8b, jedi_30p, \
        moonshot_v1_16b_a3b
    from repro_torch.core import interaction_net as inet
    from repro_torch.core import paths
    from repro_torch.data.jets import make_jets
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.moe_dispatch import a2a_moe
    from repro_torch.serving.resilient import ResilientEngine
    from repro_torch.serving.trigger import make_stream
    from repro_torch.training import grad_compression as gc
    from repro_torch.training import init_state, make_optimizer, \
        make_train_step
    from repro_torch.training.schedule import constant

    def full(tree):
        return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                        else t, tree)

    def timed_steps(step, state, batch, n):
        """``n`` steps; (state, metrics, ms per step over steps 2..n)."""
        state, m = step(state, batch)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (
            lambda: None)
        sync()
        t0 = time.perf_counter()
        for _ in range(n - 1):
            state, m = step(state, batch)
        sync()
        return state, m, (time.perf_counter() - t0) / max(n - 1, 1) * 1e3

    out: dict = {"card": card}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_md_")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/store", world_size=1, rank=0,
        timeout=timedelta(seconds=120),
        **({"device_id": torch.device("cuda", 0)} if dev.type == "cuda"
           else {}))
    try:
        mesh = init_device_mesh(dev.type, (1, 1),
                                mesh_dim_names=("data", "model"))

        # -- a. sharded train steps ------------------------------------------
        cfg = jedi_30p.MODEL
        print(f"== 11a. jedinet-30p AdamW steps on a (1, 1) (data, model) "
              f"DeviceMesh over a world-size-1 {backend} group "
              f"(B={MD_JEDI_BATCH})")
        opt = make_optimizer("adamw", constant(1e-3))
        state = init_state(0, lambda s: inet.init(s, cfg, device=dev), opt)
        x, y = make_jets(np.random.RandomState(5), MD_JEDI_BATCH,
                         cfg.n_objects)
        batch = {"x": torch.from_numpy(x).to(dev),
                 "y": torch.from_numpy(y).to(dev)}
        step = make_train_step(lambda p, b: inet.loss_fn(p, cfg, b), opt)
        ref, ref_m, ref_ms = timed_steps(
            step, tree_map(torch.clone, state), batch, MD_JEDI_STEPS)
        st_sh = shd.train_state_shardings(state, mesh)
        sharded = shd.distribute(state, st_sh)
        b_sh = shd.distribute(batch, shd.batch_shardings(
            batch, mesh, {"x": ("batch", None, None), "y": ("batch",)}))
        with shd.axis_rules(mesh):
            sharded, m, sh_ms = timed_steps(step, sharded, b_sh,
                                            MD_JEDI_STEPS)
        perr = _tree_err(full(sharded["params"]), ref["params"])
        lerr = abs(float(m["loss"].full_tensor()) - float(ref_m["loss"]))
        gerr = abs(float(m["grad_norm"].full_tensor())
                   - float(ref_m["grad_norm"])) / float(ref_m["grad_norm"])
        check(all(isinstance(t, DTensor)
                  for t in tree_leaves(sharded["params"]))
              and perr <= TOL_SHARDED and lerr <= TOL_SHARDED
              and gerr <= TOL_SHARDED,
              f"jedinet-30p sharded vs unsharded after {MD_JEDI_STEPS} AdamW "
              f"steps: params {perr:.2e} of scale, loss {lerr:.2e}, grad "
              f"norm {gerr:.2e} relative (tol {TOL_SHARDED:g})")
        print(f"  jedinet-30p B={MD_JEDI_BATCH}: {sh_ms:.3f} ms/step sharded "
              f"(DTensor), {ref_ms:.3f} ms/step unsharded (host clock, steps "
              f"2-{MD_JEDI_STEPS})  [{card}]")
        out["jedi_30p"] = {"batch": MD_JEDI_BATCH, "steps": MD_JEDI_STEPS,
                           "ms_per_step_sharded": sh_ms,
                           "ms_per_step_unsharded": ref_ms,
                           "params_err": perr, "loss_err": lerr,
                           "grad_norm_err": gerr}
        jedi_state = sharded

        lcfg = dataclasses.replace(h2o_danube_1_8b.MODEL,
                                   n_layers=MD_LM_LAYERS,
                                   compute_dtype="float32", remat="none")
        print(f"== 11a. h2o-danube-1.8b cut to {MD_LM_LAYERS} layers at full "
              f"width, fp32, one Adafactor step with its param shardings "
              f"and constrain active ({MD_LM_BATCH} x {MD_LM_SEQ} tokens)")
        lopt = make_optimizer("adafactor", constant(1e-3))
        lstate = init_state(0, lambda s: tfm.init(s, lcfg, device=dev), lopt)
        toks = torch.from_numpy(np.random.RandomState(6).randint(
            0, lcfg.vocab_size, (MD_LM_BATCH, MD_LM_SEQ)).astype(np.int32))
        lbatch = {"tokens": toks.to(dev),
                  "labels": torch.roll(toks, -1, 1).to(dev)}
        lstep = make_train_step(lambda p, b: tfm.loss_fn(p, lcfg, b), lopt)
        with tfm.xla_rounding():
            lref_ms = _wall_ms(lambda: lstep(tree_map(torch.clone, lstate),
                                             lbatch), dev, reps=1)
            lref, lref_m = lstep(tree_map(torch.clone, lstate), lbatch)
        t0 = time.perf_counter()
        lsh = shd.distribute(lstate, shd.train_state_shardings(lstate, mesh))
        lb = shd.distribute(lbatch, shd.batch_shardings(
            lbatch, mesh, {"tokens": ("batch", None),
                           "labels": ("batch", None)}))
        with tfm.xla_rounding(), shd.axis_rules(mesh):
            lsh, lm_m = lstep(lsh, lb)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        lsh_ms = (time.perf_counter() - t0) * 1e3
        lperr = _tree_err(full(lsh["params"]), lref["params"])
        llerr = abs(float(lm_m["loss"].full_tensor())
                    - float(lref_m["loss"])) / float(lref_m["loss"])
        wq = lsh["params"]["layers"]["attn"]["wq"]["w"]
        check(tuple(shd.NamedSharding(mesh, shd.P(None, "data", "model"))
                    .placements) == tuple(wq.placements)
              and lperr <= TOL_SHARDED and llerr <= TOL_SHARDED,
              f"danube {MD_LM_LAYERS} layers sharded vs unsharded step: "
              f"params {lperr:.2e} of scale, loss {llerr:.2e} relative "
              f"(tol {TOL_SHARDED:g}); wq placements {tuple(wq.placements)}")
        print(f"  danube {MD_LM_LAYERS} layers: first sharded step "
              f"{lsh_ms:.1f} ms (placement and DTensor's sharding "
              f"propagation included), unsharded {lref_ms:.1f} ms (host "
              f"clock, after a warm-up step)  [{card}]")
        out["danube_2_layers"] = {
            "tokens": [MD_LM_BATCH, MD_LM_SEQ],
            "first_step_ms_sharded": lsh_ms, "step_ms_unsharded": lref_ms,
            "params_err": lperr, "loss_err": llerr}
        del lstate, lsh, lref, lb, lbatch
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- b. the int8 all-reduce and the all-to-all dispatch ---------------
        print(f"== 11b. ef_compressed_psum on the {backend} group (int32 "
              "sums)")
        gen = torch.Generator(device=dev).manual_seed(7)
        grads = {"w": torch.randn((2560, 2560), generator=gen, device=dev),
                 "b": [torch.randn((2560,), generator=gen, device=dev)
                       * 1e-3]}
        resid = tree_map(torch.zeros_like, grads)
        mean, new_r = gc.ef_compressed_psum(grads, resid)
        ok = True
        for g, mn, r in zip(tree_leaves(grads), tree_leaves(mean),
                            tree_leaves(new_r)):
            q, s = gc.quantize(g)
            deq = gc.dequantize(q, s)
            ok = ok and torch.equal(mn, deq) and torch.equal(r, g - deq)
        ef_ms = _wall_ms(lambda: gc.ef_compressed_psum(grads, resid), dev)
        check(ok, "ef_compressed_psum over one rank: the mean is the "
              "dequantized int8 value and the residual the rest, bitwise")
        n_values = sum(t.numel() for t in tree_leaves(grads))
        print(f"  ef_compressed_psum over {n_values:,} fp32 values: "
              f"{ef_ms:.3f} ms (host clock)  [{card}]")
        out["ef_psum_ms"] = ef_ms

        mcfg = moonshot_v1_16b_a3b.MODEL
        moe = dataclasses.replace(
            mcfg.moe, capacity_factor=mcfg.moe.n_experts / mcfg.moe.top_k)
        print(f"== 11b. a2a_moe at one moonshot-v1-16b-a3b layer "
              f"({moe.n_experts} experts, top-{moe.top_k}, d_model "
              f"{mcfg.d_model}, T={MD_MOE_TOKENS}, fp32, capacity factor "
              "E/k)")
        params = {"router": {}, "experts": {}}
        for (group, name), (_, shape, std) in moe_lib.moe_shapes(
                moe, mcfg.d_model, mcfg.d_ff).items():
            params[group][name] = torch.randn(
                shape, generator=gen, device=dev) * std
        xt = torch.randn((MD_MOE_TOKENS, mcfg.d_model), generator=gen,
                         device=dev)
        want, _ = moe_lib.moe_apply(params, moe, xt,
                                    compute_dtype=torch.float32)
        got = a2a_moe(xt, params, moe)
        err, rel = err_of(got, want)
        check(got.shape == want.shape and bool(torch.isfinite(got).all())
              and rel <= TOL_A2A,
              f"a2a_moe vs moe_apply: max|err| {err:.3e} ({rel:.2e} of "
              f"scale, tol {TOL_A2A:g})")
        a2a_ms = _wall_ms(lambda: a2a_moe(xt, params, moe), dev)
        apply_ms = _wall_ms(lambda: moe_lib.moe_apply(
            params, moe, xt, compute_dtype=torch.float32), dev)
        print(f"  a2a_moe {a2a_ms:.3f} ms, moe_apply {apply_ms:.3f} ms (host "
              f"clock, one rank: no collective crosses a link)  [{card}]")
        out["moonshot_moe_layer"] = {"tokens": MD_MOE_TOKENS,
                                     "a2a_moe_ms": a2a_ms,
                                     "moe_apply_ms": apply_ms,
                                     "max_abs_err": err, "rel_err": rel}
        del params, xt, want, got
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- c. the data-parallel trigger engine ---------------------------
        shards = [dev, dev]
        print(f"== 11c. fused_full through ResilientEngine with shards="
              f"{[str(s) for s in shards]}, {MD_STREAM} batches of 256")
        p30 = inet.init(0, cfg, scale="lecun", device=dev)
        rng = np.random.RandomState(8)
        stream = make_stream(rng, MD_STREAM, 256, cfg.n_objects,
                             cfg.n_features)
        requests = make_stream(rng, 4, 256, cfg.n_objects, cfg.n_features)
        # B1 runs at 128 rows a launch here: each served batch is also held
        # against the plain forward on the same events
        plain = [inet.forward_sr_split(p30, cfg, torch.from_numpy(r).to(dev))
                 for r in requests]
        tol = paths.get("fused_full").tolerance
        served, rates, plain_rel, b1_launches = {}, {}, {}, 0
        for n in (2, 1):
            eng = ResilientEngine(p30, cfg, forward="fused_full",
                                  device=dev, shards=[dev] * n,
                                  max_batch=256)
            zero_counts(kernels)
            res = eng.run_stream(stream, warmup=2)
            outs = [eng.infer(r) for r in requests]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = b1.counter.launches
            b1_launches += launches
            n_batches = len(stream) + len(requests)
            rates[n] = len(res["latencies"]) / res["wall_s"]
            served[n] = outs
            h = eng.health()
            rel = max(err_of(torch.from_numpy(o).to(dev), want)[1]
                      for o, want in zip(outs, plain))
            plain_rel[n] = rel
            check(eng.n_shards == n and res["bucket"] == 256
                  and eng.active_path(256) == "fused_full"
                  and not fault_counters(h["counters"])
                  and (dev.type != "cuda" or launches == n * n_batches)
                  and all(np.isfinite(o).all() and o.shape == (
                      256, cfg.n_targets) for o in outs)
                  and rel <= tol,
                  f"{n} shard(s): bucket {res['bucket']}, path "
                  f"{eng.active_path(256)}, counters "
                  f"{fault_counters(h['counters']) or 'none'},"
                  f" {b1.name} launches {launches} == {n} x {n_batches} "
                  f"served batches; served logits vs plain "
                  f"forward_sr_split {rel:.2e} of scale (tol {tol:g})")
        bitwise = all(np.array_equal(a, b) for a, b in zip(served[1],
                                                            served[2]))
        gap = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
                  for a, b in zip(served[2], served[1]))
        check(gap <= TOL_FP32,
              f"2-shard logits vs 1-shard on the same batches: {gap:.2e} of "
              f"scale (tol {TOL_FP32:g}), bitwise equal: {bitwise}")
        print(f"  fused_full jedi_30p: {rates[2]:.1f} batches/s with 2 shards"
              f" on one card, {rates[1]:.1f} with 1 (run_stream, "
              f"{MD_STREAM - 2} timed batches)  [{card}]")
        out["trigger_dp"] = {"batches_per_s": {"1": rates[1], "2": rates[2]},
                             "bitwise_equal": bitwise, "rel_gap": gap,
                             "rel_err_vs_plain": {"1": plain_rel[1],
                                                  "2": plain_rel[2]},
                             "b1_launches": b1_launches}

        # -- d. elastic restore ---------------------------------------------
        print("== 11d. 11a's sharded jedinet state saved, restored onto a 1-D "
              "(data,) mesh")
        cm = CheckpointManager(f"{tmp}/ckpt")
        cm.save(MD_JEDI_STEPS, jedi_state)
        host_mesh = make_host_mesh(dev.type)
        saved = full(jedi_state)
        restored, step = cm.restore(
            device=dev, shardings=shd.train_state_shardings(saved, host_mesh))
        same = all(torch.equal(a.full_tensor(), b) for a, b in zip(
            tree_leaves(restored["params"]), tree_leaves(saved["params"])))
        check(same and step == MD_JEDI_STEPS
              and int(restored["step"].full_tensor()) == MD_JEDI_STEPS
              and all(t.device_mesh.mesh_dim_names == ("data",)
                      for t in tree_leaves(restored["params"])),
              f"restored at step {step} onto the (data,) mesh, params "
              f"bitwise equal to the saved ones: {same}")
    finally:
        dist.destroy_process_group()
    b1_total = out["trigger_dp"].pop("b1_launches")
    out["b1_launches"] = b1_total
    return out


# ---- phase 12: the cell programs, the dry run and the H100 roofline ---------

#: 12a: one dry-run cell per family at full width on the 16 x 16 mesh of
#: fake ranks (the card's host does this work).
DRYRUN_CELLS = (("jedinet-30p", "stream_1k"), ("fm", "train_batch"),
                ("gcn-cora", "minibatch_lg"),
                ("h2o-danube-1.8b", "decode_32k"))
#: 12b: cells run for real on the card at full width.
CARD_CELLS = (("jedinet-30p", "stream_1k"), ("jedinet-30p", "train_jets"),
              ("fm", "serve_bulk"), ("gcn-cora", "full_graph_sm"),
              ("h2o-danube-1.8b", "decode_32k"))
#: 12b: a cell's step against the entry point it wraps, where the two
#: call orders differ, of scale (at least 1); else bitwise.
TOL_CELL = 1e-6
#: 12b: the card's count of a step against the fake count of the same
#: cell at chips=1: FLOPs within 1%; peak memory within 15%, held in two
#: parts that each side measures on its own, the step's inputs and what
#: the step adds to them.
TOL_CELL_FLOPS, TOL_CELL_PEAK = 0.01, 0.15
#: 12b: the danube cell's cache: every one of its T = 4,096 slots written
#: (positions 4,096..8,191), the step at position 8,192.
CELL_DECODE_POS = 8192


def host_line() -> str:
    """The host's CPU model (``lscpu``), architecture and cores: the dry
    run is host work."""
    import os
    import platform
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    info = dict(ln.split(":", 1) for ln in out.splitlines() if ":" in ln)
    info = {k.strip(): v.strip() for k, v in info.items()}
    model = info.get("Model name", "unknown")
    if model == "unknown":            # a VM may hide the name
        model = (f"{info.get('Vendor ID', '?')} family "
                 f"{info.get('CPU family', '?')} model {info.get('Model', '?')}")
    return f"{model} ({platform.machine()}), {os.cpu_count()} cores"


def _cell_inputs(arch, shape_name: str, prog, a_args, dev):
    """Real args of a card cell, made as the abstract ones say: weights
    from ``init(int)`` on the card, data from the repo's generators or
    seeded ids in range.  Returns (args, entry): ``entry(args)`` runs the
    entry point the cell wraps on copies where the step writes;
    ``entry.timed`` (where set) runs it on the state itself, for
    timing."""
    from repro_torch.common.tree import tree_map
    from repro_torch.core import interaction_net as inet
    from repro_torch.data.graphs import community_graph
    from repro_torch.data.jets import jet_batches, make_jets
    from repro_torch.data.recsys_data import ctr_batches
    from repro_torch.launch.train import make_program
    from repro_torch.models import recsys as fm_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.gnn import GNN_MODULES

    cfg = arch.model

    def to_dev(batch):
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in batch.items()}

    def train_state(params):
        return {"params": params, "opt": prog.optimizer.init(params),
                "step": torch.ones((), dtype=torch.int32, device=dev)}

    def program_step(program_step_fn):
        # the program's step on a copy of the state: the step updates
        # params and moments in place
        def entry(args):
            return program_step_fn(tree_map(torch.clone, args[0]), args[1])
        entry.timed = lambda args: program_step_fn(*args)
        return entry

    if shape_name == "stream_1k":
        x = make_jets(np.random.RandomState(12), a_args[1].shape[0],
                      cfg.n_objects, cfg.n_features)[0]
        args = (inet.init(0, cfg, device=dev), torch.from_numpy(x).to(dev))
        return args, lambda a: inet.forward_sr_split(a[0], cfg, a[1],
                                                     grid=False)
    if shape_name == "train_jets":
        batch = next(jet_batches(0, a_args[1]["x"].shape[0], cfg.n_objects,
                                 cfg.n_features))
        args = (train_state(inet.init(0, cfg, device=dev)), to_dev(batch))
        # the jedi program at lr 1e-3: warmup 1e-3 * t / 50, the cell's
        # 2e-3 * t / 100, the same fp32 rates
        return args, program_step(make_program(
            arch.arch_id, batch["x"].shape[0], 1e-3, device=dev)[1])
    if shape_name == "serve_bulk":
        ids = next(ctr_batches(0, a_args[1].shape[0], cfg.vocab_sizes))["ids"]
        args = (fm_lib.init(0, cfg, device=dev), torch.from_numpy(ids).to(dev))
        return args, lambda a: fm_lib.forward(a[0], cfg, a[1])
    if shape_name == "full_graph_sm":
        g = a_args[1]
        n, e, d_in = g["x"].shape[0], g["senders"].shape[0], g["x"].shape[1]
        graph = community_graph(0, n, e, d_in, n_classes=cfg.n_classes)
        params = GNN_MODULES[cfg.kind].init(0, cfg, d_in, cfg.n_classes,
                                            device=dev)
        args = (train_state(params), to_dev(graph))
        # the gnn program at lr 5e-4: warmup 5e-4 * t / 50, the cell's
        # 1e-3 * t / 100
        return args, program_step(make_program(arch.arch_id, 0, 5e-4,
                                               device=dev)[1])
    if shape_name == "decode_32k":
        b = a_args[2].shape[0]
        params = tfm.init(0, cfg, device=dev)
        cache = tfm.init_cache(cfg, b, arch.shapes[shape_name].dim(
            "seq_len"), device=dev)
        t = cache["k"].shape[2]
        gen = torch.Generator(device=dev).manual_seed(13)
        for i in range(cfg.n_layers):
            for kv in ("k", "v"):
                cache[kv][i].copy_(torch.randn(
                    cache[kv].shape[1:], generator=gen, device=dev))
        cache["slot_pos"].copy_(torch.arange(
            CELL_DECODE_POS - t, CELL_DECODE_POS, dtype=torch.int32,
            device=dev).expand(b, t))
        cache["pos"].fill_(CELL_DECODE_POS)
        tokens = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                               device=dev, dtype=torch.int32)
        return (params, cache, tokens), lambda a: tfm.decode_step(
            a[0], cfg, a[1], a[2])
    raise ValueError(f"no card cell for {arch.arch_id} x {shape_name}")


def cell_programs(dev, card: str, kernels, b5: Kernel) -> dict:
    """Phase 12: the cell programs (``launch/steps.py``), the dry run
    (``launch/dryrun.py``) and the H100 roofline (``launch/roofline.py``).
    12a runs one cell per family on the 16 x 16 mesh of fake ranks; 12b
    runs real cells on the card on a (1, 1) mesh over a world-size-1 NCCL
    group, each held against the entry point it wraps, timed, counted and
    set beside its roofline and its fake count at chips=1.  Returns B5's
    12b launches (counts set to 0 just before the cells and read just
    after) and the phase's numbers.  The group is destroyed on the way
    out, on failure too."""
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.steps import build_cell, place
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import axis_rules

    out: dict = {"card": card, "dryrun": {}, "cells": {}}

    # -- a. the dry run -------------------------------------------------------
    print("== 12a. dry run: one cell per family at full width on the 16 x 16 "
          "mesh of fake ranks (host work)")
    t_all = time.perf_counter()
    for arch_id, shape_name in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch_id, shape_name, False, "")
        wall = time.perf_counter() - t0
        ok = rec["status"] == "ok"
        r = rec.get("roofline", {})
        terms = (f"bound {r['bound']}, step_s {r['step_s'] * 1e3:.4f} ms "
                 f"(compute {r['compute_s'] * 1e3:.4f}, memory "
                 f"{r['memory_s'] * 1e3:.4f}, collective "
                 f"{r['collective_s'] * 1e3:.4f}); {r['flops_per_chip']:.4g} "
                 f"FLOP, {r['hbm_bytes_per_chip']:.4g} B, "
                 f"{r['coll_bytes_per_chip']:.4g} collective B per rank; "
                 f"peak {rec['memory']['peak_bytes'] / 2**30:.3f} GiB"
                 if ok else rec.get("error", "")[:300])
        check(ok, f"{arch_id} x {shape_name} @ 16x16: {rec['status']}, "
                  f"{wall:.1f} s (build {rec.get('lower_s')} s, step "
                  f"{rec.get('compile_s')} s): {terms}")
        out["dryrun"][f"{arch_id}/{shape_name}"] = {
            "status": rec["status"], "wall_s": wall,
            **({"roofline": {k: r[k] for k in (
                "bound", "step_s", "compute_s", "memory_s", "collective_s",
                "flops_per_chip", "hbm_bytes_per_chip",
                "coll_bytes_per_chip")},
                "collectives": rec["collectives"]["bytes_by_op"],
                "memory": rec["memory"]} if ok else
               {"error": rec.get("error")})}
    out["dryrun_s"] = time.perf_counter() - t_all
    out["host"] = host_line()
    print(f"  12a: {len(DRYRUN_CELLS)} cells in {out['dryrun_s']:.1f} s  "
          f"[host: {out['host']}]")

    # -- b. real cells on the card --------------------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cells_")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0,
        timeout=timedelta(seconds=120), device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        zero_counts(kernels)
        for arch_id, shape_name in CARD_CELLS:
            arch = get_arch(arch_id)
            label = f"{arch_id} x {shape_name}"
            print(f"== 12b. {label} on the card, (1, 1) mesh over a "
                  f"world-size-1 NCCL group")
            fake = dryrun.count_cell(arch, arch.shapes[shape_name], mesh)
            prog = build_cell(arch, arch.shapes[shape_name], mesh)
            a_args, in_sh, _ = prog.make_abstract()
            args, entry = _cell_inputs(arch, shape_name, prog, a_args, dev)
            same = all(tuple(a.shape) == tuple(t.shape) and a.dtype == t.dtype
                       for a, t in zip(tree_leaves(a_args),
                                       tree_leaves(args)))
            check(same, f"{label}: the real args have the abstract args' "
                        f"shapes and dtypes")
            # the real inputs' storages, counted apart from the counter
            stores = {t.untyped_storage().data_ptr():
                      t.untyped_storage().nbytes() for t in tree_leaves(args)
                      if isinstance(t, torch.Tensor)}
            dargs = place(args, in_sh)
            decode = shape_name == "decode_32k"
            rounding = tfm.xla_rounding() if decode else \
                contextlib.nullcontext()
            with rounding:
                res = _card_cell(label, prog, args, dargs, entry, mesh,
                                 decode, dev, card, roofline, axis_rules,
                                 DTensor)
            fake_mem = fake["memory"]
            res["fake"] = {"flops_per_chip": fake["roofline"][
                "flops_per_chip"], "peak_bytes": fake_mem["peak_bytes"],
                "argument_bytes": fake_mem["argument_bytes"],
                "step_s": fake["roofline"]["step_s"]}
            flops_c, flops_f = res["flops_per_chip"], fake["roofline"][
                "flops_per_chip"]
            flops_gap = abs(flops_c - flops_f) / max(flops_f, 1.0)
            # the inputs: the real args' storages vs the fake count's; what
            # the step adds: the allocator's peak over what was allocated
            # before it vs the fake count's peak less its inputs
            res["card_arg_bytes"] = sum(stores.values())
            arg_gap = abs(res["card_arg_bytes"] - fake_mem[
                "argument_bytes"]) / fake_mem["argument_bytes"]
            fake_step = fake_mem["peak_bytes"] - fake_mem["argument_bytes"]
            step_gap = abs(res["card_step_bytes"] - fake_step) / fake_step
            res.update(flops_gap=flops_gap, arg_gap=arg_gap,
                       step_gap=step_gap)
            check(flops_gap <= TOL_CELL_FLOPS,
                  f"{label}: FLOPs counted on the card step {flops_c:.6g} vs "
                  f"the fake count at chips=1 {flops_f:.6g}: {flops_gap:.2e} "
                  f"(tol {TOL_CELL_FLOPS:g})")
            check(arg_gap <= TOL_CELL_PEAK,
                  f"{label}: the step's inputs on the card (their storages) "
                  f"{res['card_arg_bytes'] / 2**30:.4f} GiB vs the fake "
                  f"count's {fake_mem['argument_bytes'] / 2**30:.4f} GiB: "
                  f"{arg_gap:.2%} (tol {TOL_CELL_PEAK:.0%})")
            check(step_gap <= TOL_CELL_PEAK,
                  f"{label}: what the step adds to its inputs, on the card "
                  f"(max_memory_allocated over what was allocated before "
                  f"it) {res['card_step_bytes'] / 2**20:.3f} MiB vs the fake "
                  f"count's peak less its inputs {fake_step / 2**20:.3f} "
                  f"MiB: {step_gap:.2%} (tol {TOL_CELL_PEAK:.0%})")
            out["cells"][label] = res
            del args, dargs, entry, prog
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        launched = {k.name: k.counter.launches for k in kernels
                    if k.counter.launches}
        b5_launches = launched.pop(b5.name, 0)
        n_layers = get_arch("h2o-danube-1.8b").model.n_layers
        check(not launched and b5_launches > 0
              and b5_launches % n_layers == 0,
              f"12b: {b5.name} launched {b5_launches} times (one per danube "
              f"layer per decode step), other kernels "
              f"{launched or 'none'}")
    finally:
        dist.destroy_process_group()
    out["b5_launches"] = b5_launches
    return out


def _card_cell(label, prog, args, dargs, entry, mesh, decode, dev, card,
               roofline, axis_rules, DTensor) -> dict:
    """One card cell: its step against its entry point, HeldB5 on the
    danube cell's B5 launches, ms per step of the cell's step and of the
    entry point (on the danube cell also with B5 past its op,
    :func:`dispatch_ab`), the roofline counted on the real step at
    chips=1, the memory one step adds to its inputs."""
    from repro_torch.common.tree import tree_leaves

    def step():
        with axis_rules(mesh):
            return prog.step_fn(*dargs)

    def local(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    res: dict = {}
    # the step against the entry point it wraps, on the same state
    if decode:
        params, cache, tokens = args
        slot = int(cache["pos"][0]) % cache["k"].shape[2]
        saved = {kv: cache[kv][:, :, slot].clone() for kv in ("k", "v")}
        saved_sp, saved_pos = cache["slot_pos"].clone(), cache["pos"].clone()

        def restore():
            for kv in ("k", "v"):
                cache[kv][:, :, slot] = saved[kv]
            cache["slot_pos"].copy_(saved_sp)
            cache["pos"] = saved_pos.clone()
            # the DTensor args hold pos too: the step replaced it
            dargs[1]["pos"] = DTensor.from_local(
                cache["pos"], dargs[1]["pos"].device_mesh,
                dargs[1]["pos"].placements, run_check=False)

        with HeldB5() as held:
            want_logits, _ = entry(args)
        res.update(held.check(f"{label}: the entry point's step on the "
                              f"live cache"))
        want_rows = {kv: cache[kv][:, :, slot].clone() for kv in ("k", "v")}
        want_sp = cache["slot_pos"].clone()
        restore()
        got_logits, got_cache = step()
        got = [local(got_logits)] + [cache[kv][:, :, slot].clone()
                                     for kv in ("k", "v")] + [
            cache["slot_pos"].clone(), local(got_cache["pos"])]
        want = [want_logits, want_rows["k"], want_rows["v"], want_sp,
                saved_pos + 1]
        restore()
        what = "tfm.decode_step called directly"
    elif prog.kind == "train":
        want_state, want_m = entry(args)
        new_state, m = step()
        got = [local(m["loss"]), local(m["grad_norm"])] + [
            local(t) for t in tree_leaves(new_state["params"])]
        want = [want_m["loss"], want_m["grad_norm"]] + tree_leaves(
            want_state["params"])
        what = "its train program's step"
    else:
        want, got = [entry(args)], [local(step())]
        what = "its entry point"
    torch.cuda.synchronize()
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    rel = max(err_of(g, w)[1] for g, w in zip(got, want))
    check(bitwise or rel <= TOL_CELL,
          f"{label}: the cell's step vs {what} on the same inputs: bitwise "
          f"{bitwise}, {rel:.2e} of scale (tol {TOL_CELL:g})")
    res.update(vs_entry_bitwise=bitwise, vs_entry_rel=rel)

    # ms per step (CUDA events, a warm step first, median of 5 windows)
    spread: list = []
    res["ms"] = time_ms(step, 3, spread)
    res["ms_windows"] = spread
    if decode:
        restore()
    # the entry point on the same inputs, the same way
    timed = getattr(entry, "timed", entry)
    spread = []
    res["entry_ms"] = time_ms(lambda: timed(args), 3, spread)
    res["entry_ms_windows"] = spread
    if decode:
        restore()
        res["b5_dispatch"] = dispatch_ab(f"{label}: tfm.decode_step",
                                         lambda: entry(args), 3)
        restore()
    # the roofline at chips=1, counted on one real step
    counter = roofline.StepCounter(None, mesh)
    counter.track_args(dargs)
    with counter:
        o = step()
    rec = roofline.record(counter, 1, o, dargs)
    del o
    if decode:
        restore()
    r = rec["roofline"]
    res.update(roofline=r, memory=rec["memory"],
               flops_per_chip=r["flops_per_chip"],
               ratio=res["ms"] / (r["step_s"] * 1e3),
               entry_ratio=res["entry_ms"] / (r["step_s"] * 1e3))
    # the memory one step adds to what is allocated before it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    o = step()
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - before
    del o
    if decode:
        restore()
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["card_step_bytes"] = grown
    print(f"  {label}: {res['ms']:.4f} ms per step (CUDA events) against "
          f"the roofline's step_s {r['step_s'] * 1e3:.4f} ms ({r['bound']}; "
          f"compute {r['compute_s'] * 1e3:.4f}, memory "
          f"{r['memory_s'] * 1e3:.4f} ms: {r['flops_per_chip']:.4g} FLOP "
          f"{r['flops_by_dtype']}, {r['hbm_bytes_per_chip']:.4g} B): ratio "
          f"{res['ratio']:.2f}; the entry point {res['entry_ms']:.4f} ms, "
          f"ratio {res['entry_ratio']:.2f}; max_memory_allocated "
          f"{res['max_memory_allocated'] / 2**30:.3f} GiB  [{card}]")
    return res


# ---- phase 13: the static analysis on the card ------------------------------

#: The configs phase 13 audits: the three JEDI widths whose kernels the
#: earlier phases launch (B1-B3 plans of every design).
ANALYSIS_ARCHS = ("jedi_30p", "jedi_50p", "jedi_tracks_128")


def static_analysis(card: str, kernels) -> dict:
    """``python -m repro_torch.analysis --json --arch ...`` in-process on
    the card (phase 13): the lint rules and the kernel-contract audit,
    whose card half reads the five libraries' ptxas reports and SASS and
    runs each registered path's forward once at its smallest rung.
    Requires exit status 0 and no finding; returns the phase's numbers,
    with the launches of the audit's forwards (the counts set to 0 just
    before the run and read just after) under ``launches``."""
    from repro_torch.analysis.__main__ import main as analysis_main
    print("== 13. static analysis: lint + kernel-contract audit on the card")
    zero_counts(kernels)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = analysis_main(["--json", "--arch", ",".join(ANALYSIS_ARCHS)])
    seconds = time.perf_counter() - t0
    launches = {k.name: k.counter.launches for k in kernels}
    doc = json.loads(out.getvalue())
    audit = doc.get("audit", {})
    for f in doc["findings"]:
        print(f"  [{f['rule']}] {f['location']}: {f['message']}")
    check(rc == 0 and doc["count"] == 0,
          f"analysis: {doc['count']} finding(s), exit status {rc}")
    check(audit.get("device") == "cuda", f"the audit ran on "
          f"{audit.get('device')} (the card's checks need cuda)")
    ptxas = audit.get("ptxas_functions", {})
    check(len(ptxas) == len(kernels) and all(ptxas.values()),
          f"ptxas reports read for every library: {ptxas}")
    check(audit.get("hmma_checked", 0) > 0,
          f"{audit.get('hmma_checked', 0)} HMMA instructions checked, all "
          "accumulating in F32")
    audited = audit.get("audited", {})
    check(all(audited.get(a, {}).get("paths") == 9 for a in ANALYSIS_ARCHS),
          f"containment held for the 9 registered paths at each config: "
          f"{audited}")
    # one forward per kernel path and config: fused_full and
    # int8_fused_full (B1), jedi_linear_full and int8_jedi_linear_full
    # (B2), fused (B3)
    want = {"fused_jedinet_full": 2 * len(ANALYSIS_ARCHS),
            "jedi_linear_full": 2 * len(ANALYSIS_ARCHS),
            "fused_jedinet_edge": len(ANALYSIS_ARCHS),
            "fm_interaction": 0, "flash_decode": 0}
    check(launches == want, f"the audit's forwards launched {launches}")
    tight = audit.get("tightest_registers", {})
    print(f"  {doc['count']} findings in {seconds:.1f} s (lint "
          f"{doc['timings'].get('lint_s')} s, audit "
          f"{doc['timings'].get('audit_s')} s); tightest register "
          f"allocation {tight.get('allocated')} of {tight.get('of')} "
          f"({tight.get('function')}, {tight.get('threads')} threads, "
          f"{tight.get('plan')})  [{card}]")
    return {"rules": doc.get("rules", []), "findings": doc["count"],
            "audited": audited, "ptxas_functions": ptxas,
            "hmma_checked": audit.get("hmma_checked"),
            "tightest_registers": tight, "timings": doc["timings"],
            "seconds": seconds, "launches": launches, "card": card}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.analysis import kernel_audit as KA
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
        from repro_torch.kernels.fused_jedinet.ref import fused_edge_block_ref
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
        log = build.build_log(*k.lib)
        fn = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = KA.kernel_name(line.split()[-1])
            if "registers" in line or "spill" in line:
                print(f"  {k.name} {fn}: {line.strip()}")
        spills.update({f: e.spill_bytes
                       for f, e in KA.parse_ptxas(log).items()})
    # the register-resident designs at jedi_30p (RW 20, one sender tile)
    # and jedi_50p (B1's tile design, B3's warp design at RW 64), and B2's
    # rows design (one kernel per activation)
    rows = sorted(fn for fn in spills
                  if fn.startswith("jedi_linear_rows_kernel<"))
    check(len(rows) == len(ACTIVATIONS),
          f"jedi_linear_rows_kernel: {len(rows)} instances built, one per "
          f"activation ({len(ACTIVATIONS)})")
    for fn in (*KA.NO_SPILL, *rows):
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
    case(b1, "jedi_50p fp32", c50, 1000)
    case(b1, "jedi_50p bf16", c50.with_(compute_dtype="bfloat16"), 257,
         tol=TOL_BF16)
    case(b1, "jedi_50p int8", c50, 257, quant=True)
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
        quiet = fault_counters(health["counters"])
        check(not quiet,
              f"{label}: health counters {quiet or 'none'} "
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
    peaks = (PEAK_FP32_FLOPS, PEAK_HBM_BYTES)
    rows = [time_row(k, timings[k.name], card, *peaks) for k in kernels]
    # B5 at the LM path's own decode shape (phase 7 serves it), beside
    # the decode_32k shape of its row
    lm_t = lm_decode_timing(dev)
    lm_row = time_row(b5, lm_t, card, *peaks)
    rows[4]["lm_decode"] = {key: lm_row[key] for key in (
        "at", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "ms_windows", "partitions", "partition_keys", "stages",
        "path", "blocks", "warps_per_block")}
    # and at the MoE LM's (phase 8a serves it): G = 1, D = 128
    moe_t = lm_decode_timing(dev, MOONSHOT_LM_DECODE, None,
                             "moonshot-v1-16b-a3b", 8)
    moe_row = time_row(b5, moe_t, card, *peaks)
    rows[4]["moe_decode"] = {key: moe_row[key] for key in rows[4][
        "lm_decode"]}
    # the host cost of B5's op dispatch at both LM decode shapes
    for key, t in (("lm_decode", lm_t), ("moe_decode", moe_t)):
        rows[4][key]["dispatch"] = dispatch_ab(f"B5 alone at {t.label}",
                                               t.run, 20)
    del lm_t, moe_t
    for row in (lm_row, moe_row):
        print(f"  flash_decode plan at {row['at']}: {row['partitions']} "
              f"partitions of {row['partition_keys']} keys, "
              f"{row['blocks']} blocks of {row['warps_per_block']} "
              f"warp(s), {row['stages']}-stage ring, {row['path']} path")
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
    # B1 at jedi_50p, B = 1,024 (its tile design), beside its bound and
    # its plain version
    params = inet.init(0, c50, scale="lecun", device=dev)
    x = torch.from_numpy(make_jets(np.random.RandomState(1), 1024,
                                   c50.n_objects)[0]).to(dev)
    bound = b1.jedi.bind(params, c50)

    def run50():
        return b1.jedi.run(x, bound, c50, None)

    ms50 = time_ms(run50, 50)
    prof50 = profiled_ms(run50, "jedi_fused_full")
    graph50 = graph_ms(run50)
    plain50 = time_ms(lambda: b1.jedi.plain(x, bound, c50, None), 5)
    ops_, nbytes = fused_full_work(c50, 1024)
    bound50 = max(ops_ / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    lay50 = b1.jedi.layout(c50, params, None)
    shown = "no device time" if prof50 is None else f"{prof50:.4f} ms"
    print(f"  fused_full at jedi_50p B=1024 fp32 ({lay50.design} design, "
          f"{lay50.threads} threads, {lay50.smem_bytes} B shared memory): "
          f"{ms50:.4f} ms/batch, device: torch.profiler {shown}, CUDA graph "
          f"{graph50:.4f} ms; bound {bound50:.4f} ms ({ops_ / 1e9:.4f} "
          f"GFLOP; the graph's time at {100 * bound50 / graph50:.1f}% of "
          f"its roofline); plain "
          f"{plain50:.4f} ms  [{card}]")
    rows[0]["jedi_50p"] = {"ms": ms50, "device_ms_profiler": prof50,
                           "device_ms_graph": graph50, "bound_ms": bound50,
                           "plain_ms": plain50, "design": lay50.design}
    # B3 against the unfused oracle (explicit B of every edge, summed by
    # torch.sum), beside its plain version's check in phase 2
    xk, bound, cfg = main_args[b3.name]
    got = b3.jedi.run(xk, bound, cfg, None)
    want = fused_edge_block_ref(
        inet.init(0, cfg, scale="lecun", device=dev)["fr"], cfg, xk)
    err, rel = err_of(got, want)
    check(rel <= TOL_FP32,
          f"{b3.name} {timings[b3.name].label} vs the unfused oracle "
          f"fused_edge_block_ref: max|err| {err:.3e} ({rel:.2e} of scale, "
          f"tol {TOL_FP32:g})")
    rows[2]["vs_oracle"] = {"max_abs_err": err, "of_scale": rel,
                            "oracle": "kernels/fused_jedinet/ref.py"}
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

    # ---- 6. training --------------------------------------------------------
    train = training(dev, card, kernels, b1)
    rows[0]["launches_by_phase"]["training"] = train.pop("b1_launches")
    rows[0]["launches"] += rows[0]["launches_by_phase"]["training"]
    print("training: " + json.dumps(train))
    del timings, main_args
    torch.cuda.empty_cache()

    # ---- 7. dense LM serving ----------------------------------------------
    lm = lm_serving(dev, card, kernels, b5)
    by_run = lm.pop("b5_launches")
    rows[4]["launches_by_phase"] = {"main_paths": rows[4]["launches"],
                                    **{f"lm_{k}": v for k, v in by_run.items()}}
    rows[4]["launches"] = sum(rows[4]["launches_by_phase"].values())
    rows[4]["lm_decode"]["launches"] = by_run["danube_serving"]
    print("lm: " + json.dumps(lm))
    del lm
    torch.cuda.empty_cache()

    # ---- 8. MoE LM serving ----------------------------------------------
    moe = moe_serving(dev, card, kernels, b5)
    by_run = moe.pop("b5_launches")
    rows[4]["launches_by_phase"].update(
        {f"moe_{k}": v for k, v in by_run.items()})
    rows[4]["launches"] = sum(rows[4]["launches_by_phase"].values())
    rows[4]["moe_decode"]["launches"] = by_run["moonshot_serving"]
    print("moe: " + json.dumps(moe))

    # ---- 9. LM training ---------------------------------------------------
    lm_train = lm_training(dev, card, kernels)
    print("lm_training: " + json.dumps(lm_train))
    torch.cuda.empty_cache()

    # ---- 10. the GNN zoo ----------------------------------------------------
    gnn = gnn_zoo(dev, card, kernels)
    print("gnn: " + json.dumps(gnn))
    torch.cuda.empty_cache()

    # ---- 11. multi-device -----------------------------------------------------
    md = multidevice(dev, card, kernels, b1)
    rows[0]["launches_by_phase"]["multidevice"] = md.pop("b1_launches")
    rows[0]["launches"] += rows[0]["launches_by_phase"]["multidevice"]
    print("multidevice: " + json.dumps(md))
    torch.cuda.empty_cache()

    # ---- 12. the cell programs, the dry run and the roofline ---------------
    cells = cell_programs(dev, card, kernels, b5)
    rows[4]["launches_by_phase"]["cells"] = cells.pop("b5_launches")
    rows[4]["launches"] = sum(rows[4]["launches_by_phase"].values())
    print("cells: " + json.dumps(cells))

    # ---- 13. the static analysis ------------------------------------------
    an = static_analysis(card, kernels)
    for i, k in enumerate(kernels):
        if an["launches"][k.name]:
            rows[i].setdefault("launches_by_phase", {
                "main_paths": rows[i]["launches"]})
            rows[i]["launches_by_phase"]["analysis"] = an["launches"][k.name]
            rows[i]["launches"] += an["launches"][k.name]
    print("analysis: " + json.dumps(an))

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
