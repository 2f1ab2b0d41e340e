"""The port's CUDA kernels on the card (skips without one).

Run on a machine with an H100:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
Each kernel (B1 whole JEDI-net, B2 JEDI-linear, B3 edge block, in each
of their designs) is held against its plain version at 5e-4 of the
result scale; B4 (FM
interaction) and B5 (flash decode) at 2e-4 of theirs, in fp32 and in
bf16, where kernel and plain version read the same bf16 values and sum
in fp32.  Two launches must be bitwise equal.  ``chip_smoke.py`` covers
the same ground at the repo's full widths.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import interaction_net as inet
from repro_torch.core.int8_path import quantize_params_int8
from repro_torch.data.jets import make_jets
from repro_torch.kernels.fused_jedinet import full_kernel as FK
from repro_torch.kernels.fused_jedinet import kernel as EK
from repro_torch.kernels.fused_jedinet import ops
from repro_torch.kernels.jedi_linear import linear_kernel as LK
from repro_torch.kernels.fm_interaction import kernel as FMK
from repro_torch.kernels.fm_interaction import ops as fm_ops
from repro_torch.kernels.flash_decode import kernel as FDK
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.jedi_linear import ops as jl_ops
from repro_torch.serving.core import D2H_COUNTERS, STAGING_COUNTERS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain version")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 13, 257])
@pytest.mark.parametrize("quant", [False, True])
def test_kernel_matches_plain_version(cuda, batch, quant):
    cfg = inet.JediNetConfig()
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    if quant:
        params = quantize_params_int8(params)
    x = torch.from_numpy(make_jets(np.random.RandomState(1), batch, 30)[0])
    x = x.to(cuda)
    bound = ops.bind_full(params, cfg)
    before = FK.fused_forward_full_kernel_call.launches
    out = ops.fused_forward_full(bound, cfg, x)
    assert FK.fused_forward_full_kernel_call.launches == before + 1
    ref = FK.fused_forward_full_plain(x, bound.fr, bound.fo, bound.phi,
                                      activation="relu", scales=bound.scales)
    scale = max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= 5e-4 * scale
    assert torch.equal(out, ops.fused_forward_full(bound, cfg, x))


def _check(out, ref, again, tol=5e-4):
    scale = max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol * scale
    assert torch.equal(out, again)


#: bf16, kernel vs plain version both in bf16: the same bf16 operands,
#: summed in fp32 in another order, so now and then a sum lands on the
#: other side of a bf16 rounding boundary and moves one activation by one
#: bf16 ulp (chip_smoke.py's TOL_BF16 and its reason).  At jedi_50p, 1,000
#: events: 9.4e-4 of scale, where 257 events read 6e-8.
TOL_BF16 = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 13, 257])
@pytest.mark.parametrize("quant", [False, True])
def test_jedi_linear_kernel_matches_plain_version(cuda, batch, quant):
    cfg = inet.JediNetConfig()
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    if quant:
        params = quantize_params_int8(params)
    x = torch.from_numpy(make_jets(np.random.RandomState(1), batch, 30)[0])
    x = x.to(cuda)
    bound = jl_ops.bind_linear(params, cfg)
    before = LK.jedi_linear_kernel_call.launches
    out = jl_ops.jedi_linear_forward_full(bound, cfg, x)
    assert LK.jedi_linear_kernel_call.launches == before + 1
    ref = LK.jedi_linear_forward_full_plain(
        x, bound.fr, bound.fo, bound.phi, activation="relu",
        scales=bound.scales)
    _check(out, ref, jl_ops.jedi_linear_forward_full(bound, cfg, x))


@pytest.mark.cuda
@pytest.mark.parametrize("n_o,batch,block_s", [(30, 13, None), (30, 257, None),
                                               (30, 1, None), (50, 5, None),
                                               (30, 13, 30)])
def test_edge_block_kernel_matches_plain_version(cuda, n_o, batch, block_s):
    """B3's warp design (jedi_30p, jedi_50p) and, with a pinned sender
    tile, its team layout."""
    cfg = inet.JediNetConfig(n_objects=n_o)
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    x = torch.from_numpy(make_jets(np.random.RandomState(1), batch, n_o)[0])
    x = x.to(cuda)
    bound = ops.bind_edge(params["fr"], cfg)
    before = EK.fused_edge_block_kernel_call.launches
    out = ops.fused_edge_block(bound, cfg, x, block_s=block_s)
    assert EK.fused_edge_block_kernel_call.launches == before + 1
    assert out.shape == (batch, n_o, cfg.d_e)
    ref = EK.fused_edge_block_plain(x, bound.fr, activation="relu",
                                    block_s=block_s)
    _check(out, ref, ops.fused_edge_block(bound, cfg, x, block_s=block_s))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [13, 257])
def test_jedi_linear_rows_design_at_50p(cuda, batch):
    """B2's rows design at jedi_50p (widths 50, 512 threads a block)."""
    from repro_torch.configs import jedi_50p
    cfg = jedi_50p.MODEL
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    x = torch.from_numpy(make_jets(np.random.RandomState(1), batch, 50)[0])
    x = x.to(cuda)
    bound = jl_ops.bind_linear(params, cfg)
    out = jl_ops.jedi_linear_forward_full(bound, cfg, x)
    ref = LK.jedi_linear_forward_full_plain(
        x, bound.fr, bound.fo, bound.phi, activation="relu")
    _check(out, ref, jl_ops.jedi_linear_forward_full(bound, cfg, x))


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,k", [(1, 39, 10), (7, 39, 10), (513, 39, 10),
                                   (64, 26, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fm_interaction_kernel_matches_plain_version(cuda, b, f, k, dtype):
    """Unit-normal v, held at 2e-4 of sum_k (sum_f v)^2, the scale before
    the identity's cancellation."""
    v = torch.from_numpy(np.random.RandomState(0).normal(0, 1, (b, f, k))
                         .astype(np.float32)).to(cuda).to(dtype)
    before = FMK.fm_interaction_kernel_call.launches
    out = fm_ops.fm_interaction(v)
    assert FMK.fm_interaction_kernel_call.launches == before + 1
    ref = FMK.fm_interaction_ref(v)
    scale = float(v.float().sum(1).square().sum(-1).max())
    assert out.shape == (b,) and out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= 2e-4 * scale
    assert torch.equal(out, fm_ops.fm_interaction(v))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,d,s,chunk,window,dtype,masked", [
    (2, 4, 4, 32, 256, 64, None, torch.float32, False),
    (4, 8, 2, 64, 512, 128, None, torch.float32, False),
    (1, 16, 1, 128, 1024, 256, None, torch.float32, False),
    (2, 32, 8, 80, 300, 64, None, torch.bfloat16, True),
    (2, 4, 2, 32, 256, 64, 64, torch.float32, False),
    (2, 8, 2, 33, 100, 16, None, torch.bfloat16, False),
    (3, 6, 6, 64, 256, None, None, torch.bfloat16, True),    # minicpm's MHA
])
def test_flash_decode_kernel_matches_plain_version(cuda, b, h, hkv, d, s,
                                                   chunk, window, dtype,
                                                   masked):
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.normal(0, 1, (b, h, d)).astype(np.float32))
    kv = [torch.from_numpy(rng.normal(0, 1, (b, s, hkv, d))
                           .astype(np.float32)).to(cuda).to(dtype)
          for _ in range(2)]
    q_pos = torch.from_numpy(rng.randint(1, s, b).astype(np.int32))
    kv_pos = torch.arange(s, dtype=torch.int32)[None].repeat(b, 1)
    if window is None:
        kv_pos = torch.where(kv_pos <= q_pos[:, None], kv_pos, -1)
    if masked:
        kv_pos[0] = -1
    q, q_pos, kv_pos = q.to(cuda), q_pos.to(cuda), kv_pos.to(cuda)
    before = FDK.flash_decode_kernel_call.launches
    out = fd_ops.flash_decode(q, *kv, q_pos, kv_pos, chunk=chunk,
                              window=window)
    assert FDK.flash_decode_kernel_call.launches == before + 1
    qg = (q * (1.0 / d ** 0.5)).reshape(b, hkv, h // hkv, d)
    ref = FDK.flash_decode_ref(qg, *kv, q_pos, kv_pos,
                               window=window).reshape(b, h, d)
    assert bool(torch.isfinite(out).all())
    _check_tol(out, ref, 2e-4)
    assert torch.equal(out, fd_ops.flash_decode(q, *kv, q_pos, kv_pos,
                                                chunk=chunk, window=window))


def _check_tol(out, ref, tol):
    scale = max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("b,masked", [(1, False), (2, True)])
def test_flash_decode_partitions_combine_at_danube_width(cuda, b, masked):
    """h2o-danube-1.8b's decode shape at B = 1 and 2: 128 partitions
    combined, 4 or 8 kv-heads a block on the tensor-core path; a row with
    no valid key gives the mean of v across all partitions."""
    rng = np.random.RandomState(2)
    s, h, hkv, d = 32768, 32, 8, 80
    q = torch.from_numpy(rng.normal(0, 1, (b, h, d)).astype(np.float32))
    kv = [torch.from_numpy(rng.normal(0, 1, (b, s, hkv, d))
                           .astype(np.float32)).to(torch.bfloat16).to(cuda)
          for _ in range(2)]
    q_pos = torch.full((b,), s - 1, dtype=torch.int32)
    kv_pos = torch.arange(s, dtype=torch.int32)[None].repeat(b, 1)
    if masked:
        kv_pos[0] = -1
    q, q_pos, kv_pos = q.to(cuda), q_pos.to(cuda), kv_pos.to(cuda)
    lay = FDK.plan(b, hkv, h // hkv, d, s, 2)
    assert lay.mma and lay.n_parts > 1 and lay.blocks >= 132
    out = fd_ops.flash_decode(q, *kv, q_pos, kv_pos)
    qg = (q * (1.0 / d ** 0.5)).reshape(b, hkv, h // hkv, d)
    ref = FDK.flash_decode_ref(qg, *kv, q_pos, kv_pos).reshape(b, h, d)
    _check_tol(out, ref, 2e-4)
    assert torch.equal(out, fd_ops.flash_decode(q, *kv, q_pos, kv_pos))
    if masked:
        mean_v = kv[1][0].float().mean(0).repeat_interleave(h // hkv, 0)
        assert float((out[0] - mean_v).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n_o,block_s,design", [(50, None, "warp"),
                                                (30, 30, "team")])
def test_fused_full_both_designs(cuda, n_o, block_s, design):
    """B1's warp design at N_o = 50 (each lane walks two sender tiles of
    32) and its team layout (a pinned sender tile) against the plain
    version."""
    cfg = inet.JediNetConfig(n_objects=n_o)
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    x = torch.from_numpy(make_jets(np.random.RandomState(1), 13, n_o)[0])
    x = x.to(cuda)
    bound = ops.bind_full(params, cfg)
    from repro_torch.kernels.fused_jedinet import autotune
    assert autotune.full_layout_for(cfg, params,
                                    block_s=block_s).design == design
    out = ops.fused_forward_full(bound, cfg, x, block_s=block_s)
    ref = FK.fused_forward_full_plain(x, bound.fr, bound.fo, bound.phi,
                                      activation="relu", block_s=block_s)
    _check(out, ref, ops.fused_forward_full(bound, cfg, x, block_s=block_s))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 13, 256, 1000])
@pytest.mark.parametrize("mode", ["fp32", "int8", "bf16"])
def test_fused_full_tile_design_at_50p(cuda, batch, mode):
    """B1's tile design at jedi_50p in fp32, int8 and bf16 against the
    plain version (which sums the senders in its order; 5e-4 of scale,
    bf16 :data:`TOL_BF16`), two launches bitwise equal, and one launch of
    the tile design a call."""
    from repro_torch.configs.jedi_50p import MODEL as cfg
    from repro_torch.kernels.fused_jedinet import autotune
    if mode == "bf16":
        cfg = cfg.with_(compute_dtype="bfloat16")
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    if mode == "int8":
        params = quantize_params_int8(params)
    assert autotune.full_layout_for(cfg, params).design == "tile"
    x = torch.from_numpy(
        make_jets(np.random.RandomState(1), batch, cfg.n_objects)[0])
    x = x.to(cuda).to(getattr(torch, cfg.compute_dtype))
    bound = ops.bind_full(params, cfg)
    by_design = FK.fused_forward_full_kernel_call.launches_by_design
    before = dict(by_design)
    out = ops.fused_forward_full(bound, cfg, x)
    assert by_design.get("tile", 0) == before.get("tile", 0) + 1
    assert {k: v for k, v in by_design.items() if k != "tile"} \
        == {k: v for k, v in before.items() if k != "tile"}
    ref = FK.fused_forward_full_plain(x, bound.fr, bound.fo, bound.phi,
                                      activation=cfg.activation,
                                      scales=bound.scales)
    assert out.shape == (batch, cfg.n_targets)
    assert bool(torch.isfinite(out).all())
    _check(out, ref, ops.fused_forward_full(bound, cfg, x),
           tol=TOL_BF16 if mode == "bf16" else 5e-4)


@pytest.mark.cuda
def test_fused_full_keeps_the_warp_design_at_30p(cuda):
    """jedi_30p's B1 still launches the warp design, once a call."""
    from repro_torch.configs.jedi_30p import MODEL as cfg
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    x = torch.from_numpy(
        make_jets(np.random.RandomState(1), 256, cfg.n_objects)[0])
    bound = ops.bind_full(params, cfg)
    by_design = FK.fused_forward_full_kernel_call.launches_by_design
    before = dict(by_design)
    ops.fused_forward_full(bound, cfg, x.to(cuda))
    assert by_design.get("warp", 0) == before.get("warp", 0) + 1
    assert by_design.get("tile", 0) == before.get("tile", 0)


# -- the serving front on the card --------------------------------------------

#: (path, seam, factor, the wrapper whose launches the path counts)
SILENT_ON_CARD = [
    ("int8_fused_full", "scale_drift", 8.0, FK.fused_forward_full_kernel_call),
    ("fused_full", "weight_corrupt", 8.0, FK.fused_forward_full_kernel_call),
    ("fused_full", "stale_cache", 1.0, FK.fused_forward_full_kernel_call),
    ("jedi_linear_full", "weight_corrupt", 8.0, LK.jedi_linear_kernel_call),
]


@pytest.mark.cuda
@pytest.mark.parametrize("path,seam,factor,wrapper", SILENT_ON_CARD)
def test_sentinel_catches_each_silent_seam_on_its_kernel(cuda, path, seam,
                                                         factor, wrapper):
    """EXPERIMENTS.md §Sentinel's settings at jedi_30p: detected at live
    batch 1 through the kernel's cached callable and packed weights,
    requalified at batch 9, no loud counter."""
    from repro_torch.serving import (FaultInjector, ResilientEngine,
                                     SentinelConfig)
    cfg = inet.JediNetConfig()
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    inj = FaultInjector()
    inj.arm(seam, path=path, times=1, factor=factor)
    eng = ResilientEngine(params, cfg, forward=path, device=cuda,
                          max_batch=64, injector=inj,
                          sentinel=SentinelConfig(canary_every=3,
                                                  promote_after=2,
                                                  shadow_sync=True))
    rng = np.random.RandomState(2)
    before = wrapper.launches
    states = []
    for _ in range(12):
        out = eng.infer(make_jets(rng, 61, 30)[0])
        assert np.isfinite(out).all()
        states.append(eng.health()["state"])
    assert wrapper.launches > before
    assert states[0] == "quarantined" and states.index("healthy") == 8
    c = eng.metrics.counters
    assert c["quarantines"] == 1 and c["requalifications"] == 1
    for k in ("compile_failures", "dispatch_failures", "nonfinite_batches",
              "watchdog_timeouts"):
        assert k not in c
    # canaries and live batches realized through reused output slots
    assert c["core.d2h_reused"] > 0 and c["core.d2h_early"] >= 12
    from repro_torch.core import paths
    bar = 8 * paths.get(path).tolerance
    dev = f"canary_dev_b{eng.bucket_for(61)}"
    assert eng.metrics.gauge_max(dev) > bar >= eng.metrics.gauge_value(dev)


@pytest.mark.cuda
def test_async_shadows_run_on_the_worker_stream(cuda):
    """Shadows on the worker's own CUDA stream: no disagreement, and the
    served logits bitwise equal to a sentinel-free engine's."""
    import threading

    from repro_torch.serving import ResilientEngine, SentinelConfig
    cfg = inet.JediNetConfig()
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    eng = ResilientEngine(params, cfg, forward="fused_full", device=cuda,
                          max_batch=64,
                          sentinel=SentinelConfig(shadow_rate=0.25,
                                                  shadow_sync=False))
    plain = ResilientEngine(params, cfg, forward="fused_full", device=cuda,
                            max_batch=64)
    terminal = eng._engine_for(eng.sentinel.terminal_level)
    seen = []
    infer = terminal.infer

    def spy(x, **kw):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_stream(cuda)))
        return infer(x, **kw)
    terminal.infer = spy
    rng = np.random.RandomState(3)
    try:
        for _ in range(12):
            x = make_jets(rng, 64, 30)[0]
            assert np.array_equal(eng.infer(x), plain.infer(x))
        eng.sentinel.drain()
    finally:
        eng.sentinel.close()
    c = eng.metrics.counters
    assert c["shadow_requests"] == 3 and "shadow_disagreements" not in c
    stream = eng.sentinel.shadow_stream
    assert stream is not None and stream != torch.cuda.default_stream(cuda)
    assert seen and all(name == "sentinel-shadow" and s == stream
                        for name, s in seen)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [256, 1024])
@pytest.mark.parametrize("inflight", [2, 4])
def test_async_results_equal_the_synchronous_copy(cuda, bucket, inflight):
    """``fused_full`` at ``inflight`` results in flight, each launch queued
    behind a ~1 ms sleep so that output slots are taken again while
    earlier copies are pending: every realized result is bitwise equal
    to the rung's output on the same padded batch copied to the host by
    a synchronous ``.cpu()``, and each was copied at its launch."""
    import collections

    from repro_torch.serving.core import ExecutionCore
    from repro_torch.serving.engine import TriggerWorkload
    cfg = inet.JediNetConfig()
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    core = ExecutionCore(TriggerWorkload(params, cfg, device=cuda),
                         bucket_sizes=[bucket])
    rng = np.random.RandomState(5)
    sizes = (bucket, bucket - 24, 13, bucket // 2)
    xs = [make_jets(rng, sizes[i % 4], cfg.n_objects)[0] for i in range(16)]
    pend, outs = collections.deque(), {}
    for i, x in enumerate(xs):
        if len(pend) == inflight:
            j, p = pend.popleft()
            outs[j] = p.result(timeout_s=30.0)
        torch.cuda._sleep(2_000_000)
        pend.append((i, core.infer(x, sync=False)))
    while pend:
        j, p = pend.popleft()
        outs[j] = p.result(timeout_s=30.0)
    fn = core.compiled_for(bucket)
    for i, x in enumerate(xs):
        xd = torch.from_numpy(core.workload.pad(x, bucket)).to(cuda)
        want = fn(xd).cpu().numpy()[:x.shape[0]]
        assert outs[i].tobytes() == want.tobytes(), i
    c = core.metrics.counters
    assert c["core.d2h_early"] == len(xs)
    assert c["core.d2h_reused"] > 0
    assert c.get("core.d2h_grown", 0) <= inflight + 1


@pytest.mark.cuda
def test_serving_loop_through_b1_matches_direct_infer(cuda):
    from repro_torch.serving import ResilientEngine, ServingLoop
    cfg = inet.JediNetConfig()
    params = inet.init(0, cfg, scale="lecun", device=cuda)
    eng = ResilientEngine(params, cfg, forward="fused_full", device=cuda,
                          max_batch=256)
    loop = ServingLoop(eng, deadline_s=2e-3, max_inflight=4)
    rng = np.random.RandomState(4)
    xs = [make_jets(rng, int(n), 30)[0] for n in rng.randint(1, 301, 48)]
    before = FK.fused_forward_full_kernel_call.launches
    futs = []
    for x in xs:
        futs.append(loop.submit(x))
        loop.poll()
    loop.drain()
    plans = eng.metrics.counter("loop_plans")
    assert FK.fused_forward_full_kernel_call.launches - before >= plans
    assert eng.metrics.gauge_max("inflight_plans") <= 4
    for fut, x in zip(futs, xs):
        got = fut.result()
        assert float(np.abs(got - eng.infer(x)).max()) <= 5e-4
    # a burst of six full buckets in one submit hits the cap of 2: the
    # loop blocks on the oldest plan and the gauge's peak is the cap
    eng = ResilientEngine(params, cfg, forward="fused_full", device=cuda,
                          max_batch=256)
    burst = ServingLoop(eng, deadline_s=2e-3, max_inflight=2)
    realized, realize = [], burst._realize

    def spy(entry):
        realized.append((entry[0], burst.inflight))
        realize(entry)

    burst._realize = spy
    x = make_jets(rng, 6 * 256, 30)[0]
    fut = burst.submit(x)
    assert realized[:4] == [(0, 2), (1, 2), (2, 2), (3, 2)]
    assert eng.metrics.gauge_max("inflight_plans") == 2
    burst.drain()
    assert float(np.abs(fut.result() - eng.infer(x)).max()) <= 5e-4


@pytest.mark.cuda
def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Three SGD steps of jedi_30p on the card against the same steps on
    the CPU from the same params, at 1e-4 of each leaf's largest
    magnitude (the two devices sum in another order; SGD carries that
    difference linearly)."""
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.training import make_optimizer, make_train_step
    from repro_torch.training.schedule import constant
    cfg = inet.JediNetConfig()
    params = inet.init(0, cfg, scale="lecun", device="cpu")
    states = {}
    for dev in ("cpu", cuda):
        opt = make_optimizer("sgd", constant(1e-2))
        # a copy on each device: the optimizer updates params in place
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        state = {"params": p, "opt": opt.init(p),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        step = make_train_step(lambda q, b: inet.loss_fn(q, cfg, b), opt)
        rng = np.random.RandomState(5)
        for _ in range(3):
            x, y = make_jets(rng, 256, 30)
            state, m = step(state, {"x": torch.from_numpy(x).to(dev),
                                    "y": torch.from_numpy(y).to(dev)})
        assert m["loss"].device.type == torch.device(dev).type
        states[torch.device(dev).type] = state
    for a, b in zip(tree_leaves(states["cuda"]["params"]),
                    tree_leaves(states["cpu"]["params"])):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_trained_weights_serve_through_b1(cuda):
    """jedi_30p trained on the card for 40 AdamW steps, then served
    through ``fused_full``: one B1 launch per batch, no demotion, logits
    within 5e-4 of ``forward_sr`` (scaled to at least 1), and the same
    argmax wherever the top two logits lie further apart than that."""
    from repro_torch.serving import ResilientEngine
    from repro_torch.training import init_state, make_optimizer, \
        make_train_step
    from repro_torch.training.schedule import warmup_cosine
    cfg = inet.JediNetConfig()
    opt = make_optimizer("adamw", warmup_cosine(2e-3, 10, 100))
    state = init_state(0, lambda s: inet.init(s, cfg, device=cuda), opt)
    step = make_train_step(lambda q, b: inet.loss_fn(q, cfg, b), opt)
    rng = np.random.RandomState(6)
    for _ in range(40):
        x, y = make_jets(rng, 256, 30)
        state, m = step(state, {"x": torch.from_numpy(x).to(cuda),
                                "y": torch.from_numpy(y).to(cuda)})
    assert bool(torch.isfinite(m["loss"]))
    eng = ResilientEngine(state["params"], cfg, forward="fused_full",
                          device=cuda, max_batch=256)
    xs = [make_jets(rng, 256, 30)[0] for _ in range(4)]
    before = FK.fused_forward_full_kernel_call.launches
    served = [eng.infer(x) for x in xs]
    assert FK.fused_forward_full_kernel_call.launches - before == len(xs)
    counters = eng.health()["counters"]
    assert sum(counters.pop(k, 0) for k in STAGING_COUNTERS) == len(xs)
    d2h = {k: counters.pop(k) for k in D2H_COUNTERS if k in counters}
    assert d2h.pop("core.d2h_early") == len(xs)
    assert sum(d2h.values()) == len(xs)           # one slot a launch
    assert not counters
    for x, got in zip(xs, served):
        with torch.no_grad():
            ref = inet.forward_sr(state["params"], cfg,
                                  torch.from_numpy(x).to(cuda)).cpu().numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(got - ref).max()) <= 5e-4 * scale
        top2 = np.sort(ref, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * 5e-4 * scale
        assert (got.argmax(-1) == ref.argmax(-1))[clear].all()


def _lm_cfg(dtype, window=None):
    """A narrow LM of 4 layers at danube's head shape (D = 80, G = 4, so a
    bf16 cache takes B5's tensor-core path)."""
    from repro_torch.configs.base import TransformerConfig
    return TransformerConfig(
        name="lm-card", n_layers=4, d_model=640, n_heads=8, n_kv_heads=2,
        d_ff=1024, vocab_size=1000, sliding_window=window, remat="none",
        compute_dtype=dtype)


def _plain_b5(q, k, v, q_pos, kv_pos, *, window=None, chunk=None):
    """B5's plain version on the card's tensors (what the wrapper runs on
    CPU tensors), to stand in for the kernel in a decode step."""
    return FDK.flash_decode_ref(q, k, v, q_pos, kv_pos, window=window)


class _HeldB5:
    """B5 that also holds each launch against its plain version on the
    same inputs, appending max|err| over max(1, max|plain|) to ``errs``.
    The kernel counts its launch on the module's name, so ``launches``
    reads and writes the kernel's own counter."""

    def __init__(self):
        self.launch, self.errs = FDK.flash_decode_kernel_call, []

    @property
    def launches(self):
        return self.launch.launches

    @launches.setter
    def launches(self, n):
        self.launch.launches = n

    def __call__(self, q, k, v, q_pos, kv_pos, *, window=None, chunk=None):
        out = self.launch(q, k, v, q_pos, kv_pos, window=window, chunk=chunk)
        ref = _plain_b5(q, k, v, q_pos, kv_pos, window=window)
        self.errs.append(float((out - ref).abs().max())
                         / max(1.0, float(ref.abs().max())))
        return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,window,tol", [
    ("float32", None, 2e-4), ("bfloat16", None, 5e-2),
    ("bfloat16", 24, 5e-2)])
def test_lm_decode_step_on_b5_matches_its_plain_version(cuda, monkeypatch,
                                                        dtype, window, tol):
    """``decode_step`` on the card, its attention on B5 (one launch per
    layer), against the same step with B5's plain version, on one cache
    filled by 40 steps (with a window of 24 the ring has wrapped).  fp32:
    B5's own bar, 2e-4 of max(1, max |logit|).  bf16: the reference's bf16
    bar for B5, 5e-2.  The two attentions agree to fp32 summation order,
    but one output that lands on the other side of a bf16 rounding makes
    the two steps round independently from there on: each of a layer's
    ~11 roundings on the residual stream's way moves its value by up to
    2^-9 of it, so after 4 layers the logits of the two steps lie ~1e-2
    of scale apart (1.08e-2 on an H100), where a wrong mask, slot or
    position moves them by O(1).  The sharp check, in both dtypes: each
    layer's B5 launch against its plain version on that launch's own
    inputs, at B5's 2e-4."""
    from repro_torch.models import transformer as tfm
    cfg = _lm_cfg(dtype, window)
    params = tfm.compute_params(tfm.init(0, cfg, device=cuda), cfg)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (3, 41), generator=gen).to(cuda)
    cache = tfm.init_cache(cfg, 3, 64, device=cuda)
    with tfm.xla_rounding():
        for t in range(40):
            _, cache = tfm.decode_step(params, cfg, cache, toks[:, t])
        twin = {k: v.clone() for k, v in cache.items()}
        before = FDK.flash_decode_kernel_call.launches
        held = _HeldB5()
        monkeypatch.setattr(FDK, "flash_decode_kernel_call", held)
        got, cache = tfm.decode_step(params, cfg, cache, toks[:, 40])
        monkeypatch.undo()
        assert FDK.flash_decode_kernel_call.launches - before == cfg.n_layers
        assert len(held.errs) == cfg.n_layers and max(held.errs) <= 2e-4
        monkeypatch.setattr(FDK, "flash_decode_kernel_call", _plain_b5)
        want, twin = tfm.decode_step(params, cfg, twin, toks[:, 40])
    assert bool(torch.isfinite(got).all())
    _check_tol(got, want, tol)
    assert torch.equal(cache["slot_pos"], twin["slot_pos"])


@pytest.mark.cuda
def test_lm_engine_on_the_card_decodes_through_b5(cuda, monkeypatch):
    """LMEngine on the card, fp32: B5 launched once per layer per decode
    step, and the same greedy tokens as the engine with B5's plain
    version."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import LMEngine
    cfg = _lm_cfg("float32")
    params = tfm.init(0, cfg, device=cuda)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (7, 30, 12, 50, 3)]

    def serve():
        eng = LMEngine(params, cfg, slots=3, max_seq=64, device=cuda)
        for p in prompts:
            eng.submit(p, 6)
        return eng.run()

    before = FDK.flash_decode_kernel_call.launches
    got = serve()
    assert FDK.flash_decode_kernel_call.launches - before \
        == cfg.n_layers * got["steps"]
    monkeypatch.setattr(FDK, "flash_decode_kernel_call", _plain_b5)
    want = serve()
    assert [r.out for r in got["done"]] == [r.out for r in want["done"]]


@pytest.mark.cuda
def test_moe_apply_on_the_card_matches_the_cpu_and_reads_nothing_back(cuda):
    """``models.moe.moe_apply`` on the card at moonshot's routing (64
    experts, top-6, capacity factor 1.25; T = 40, so drops bind) in fp32
    against its CPU run on the same inputs, at 2e-4 of max(1, max |out|);
    and in bf16 under CUDA's sync debug mode set to "error", so any read
    back to the host (``.item()``, ``nonzero``, a boolean mask) raises."""
    from repro_torch.common import prng
    from repro_torch.common.tree import tree_map
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    m = MoEConfig(n_experts=64, top_k=6)
    params = moe.init_moe(prng.key(0), m, 256, 128, device="cpu")
    x = torch.randn((40, 256), generator=torch.Generator().manual_seed(0))
    want, want_aux = moe.moe_apply(params, m, x, compute_dtype=torch.float32)
    on_card = tree_map(lambda t: t.to(cuda), params)
    got, aux = moe.moe_apply(on_card, m, x.to(cuda),
                             compute_dtype=torch.float32)
    scale = max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= 2e-4 * scale
    assert abs(float(aux) - float(want_aux)) <= 2e-4 * float(want_aux)
    bf = tree_map(lambda t: t.to(torch.bfloat16), on_card)
    xb = x.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = moe.moe_apply(bf, m, xb, compute_dtype=torch.bfloat16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pna", "equiformer_v2"])
def test_gnn_on_the_card_matches_the_cpu_and_reads_nothing_back(cuda, kind):
    """A narrow pna (2 layers x 16, its 12 aggregated views) and
    equiformer-v2 (2 layers, C = 16, l_max 6, m_max 2, 2 heads) on a
    random graph: the forward and the gradients of a scalar loss on the
    card against the CPU's at 2e-4 of max(1, scale) (each gradient leaf
    floored at 1e-4 of the tree's largest), then one forward and backward
    under CUDA's sync debug mode "error" (after a warm one, which puts
    the SO(3) constants on the card)."""
    from repro_torch.common import prng
    from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.gnn import GNN_MODULES
    arch = {"pna": "pna", "equiformer_v2": "equiformer-v2"}[kind]
    full = get_arch(arch).model
    cfg = dataclasses.replace(full, n_layers=2, d_hidden=16,
                              n_heads=min(full.n_heads, 2))
    mod = GNN_MODULES[kind]
    rng = np.random.RandomState(0)
    n, e, d = 200, 1200, 8
    graph = {
        "x": torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)),
        "pos": torch.from_numpy(rng.normal(0, 1, (n, 3)).astype(np.float32)),
        "senders": torch.from_numpy(rng.randint(0, n, e).astype(np.int32)),
        "receivers": torch.from_numpy(rng.randint(0, n, e).astype(np.int32)),
    }
    params = mod.init(prng.key(0), cfg, d, cfg.n_classes, device="cpu")

    def fwd_bwd(p, g):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(p)]
        out = mod.apply(tree_unflatten(p, leaves), cfg, g)
        return out, torch.autograd.grad(out.square().mean(), leaves)

    want, want_g = fwd_bwd(params, graph)
    want = want.detach()
    on_card = tree_map(lambda t: t.to(cuda), params)
    g_card = {k: v.to(cuda) for k, v in graph.items()}
    got, got_g = fwd_bwd(on_card, g_card)
    got = got.detach()
    scale = max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= 2e-4 * scale
    floor = 1e-4 * max(float(g.abs().max()) for g in want_g)
    for a, b in zip(want_g, got_g):
        s = max(float(a.abs().max()), floor)
        assert float((b.cpu() - a).abs().max()) <= 2e-4 * s
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, grads = fwd_bwd(on_card, g_card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out).all())
