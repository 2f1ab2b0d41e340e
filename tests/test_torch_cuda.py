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


def _check(out, ref, again):
    scale = max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= 5e-4 * scale
    assert torch.equal(out, again)


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
