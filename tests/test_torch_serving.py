"""The port's serving stack on ``device="cpu"``: engine, ladder, CLI.

The resilient engine serves through the kernel paths' plain versions
here, and its logits are held against the JAX reference's
``forward_sr`` on the same numpy inputs and bridged weights at 5e-4.
Fault drills follow ``tests/test_faults.py``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import int8_path as jint8
from repro.core import interaction_net as jinet
from repro.data.jets import make_jets
from repro_torch import bridge
from repro_torch.core import interaction_net as tinet
from repro_torch.launch import trigger_serve
from repro_torch.serving import (
    DeviceResult,
    FaultInjector,
    ResilientEngine,
    ServingEngine,
    ServingMetrics,
    serve_stream,
)
from repro_torch.serving.faults import StuckBuffer
from repro_torch.serving.trigger import make_stream

SMALL = dict(n_objects=13, fr_hidden=(16, 12), fo_hidden=(10,),
             phi_hidden=(12,))


def _jax_and_port(batch, n_batches=1, **cfg_kw):
    jcfg = jinet.JediNetConfig(**cfg_kw)
    tcfg = tinet.JediNetConfig(**cfg_kw)
    jp = jax.tree_util.tree_map(
        np.asarray, jinet.init(jax.random.PRNGKey(0), jcfg, scale="lecun"))
    rng = np.random.RandomState(1)
    xs = [make_jets(rng, batch, jcfg.n_objects)[0] for _ in range(n_batches)]
    return jcfg, tcfg, jp, bridge.params_from_jax(jp, device="cpu"), xs


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg, jp, tp, xs = _jax_and_port(5, **SMALL)
    ref = np.asarray(jinet.forward_sr(jp, jcfg, jnp.asarray(xs[0])))
    return tcfg, tp, xs[0], ref


def _engine(small, injector=None, **kw):
    cfg, params, _, _ = small
    kw.setdefault("watchdog_s", 5.0)
    return ResilientEngine(params, cfg, forward="fused_full", device="cpu",
                           max_batch=16, injector=injector, **kw)


# -- the main path against JAX ------------------------------------------

def test_resilient_engine_serves_stream_equal_to_jax_forward_sr():
    jcfg, tcfg, jp, tp, xs = _jax_and_port(6, n_batches=3)
    eng = ResilientEngine(tp, tcfg, forward="fused_full", device="cpu",
                          max_batch=8)
    res = eng.run_stream(xs, warmup=1)
    assert res["events"] == 12 and res["bucket"] == 8
    for x in xs:
        want = np.asarray(jinet.forward_sr(jp, jcfg, jnp.asarray(x)))
        got = eng.infer(x)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    assert eng.health()["state"] == "healthy"
    assert not eng.health()["counters"]
    assert eng.active_path(8) == "fused_full"


def test_int8_engine_equal_to_jax_int8_reference():
    jcfg, tcfg, jp, tp, xs = _jax_and_port(3, **SMALL)
    jq = jax.tree_util.tree_map(np.asarray, jint8.quantize_params_int8(jp))
    want = np.asarray(jint8._ref_int8(jq, jcfg, jnp.asarray(xs[0])))
    eng = ResilientEngine(tp, tcfg, forward="int8_fused_full", device="cpu",
                          max_batch=8)
    np.testing.assert_allclose(eng.infer(xs[0]), want, rtol=0, atol=5e-4)
    assert eng.chain == ["int8_fused_full", "fused_full", "sr_split"]


def test_engine_pads_to_bucket_and_chunks(small):
    cfg, params, x, ref = small
    eng = ServingEngine(params, cfg, forward="fused_full", device="cpu",
                        max_batch=16)
    assert eng.bucket_sizes == [8, 16]
    big = np.concatenate([x] * 7)        # 35 rows: chunks of 16, 16 and 3
    out = eng.infer(big)
    np.testing.assert_allclose(out, np.concatenate([ref] * 7), atol=5e-4)
    assert eng.cache_size == 2                   # buckets 16 and 8
    pending = eng.infer(x, sync=False)
    assert pending.ready
    np.testing.assert_allclose(pending.result(), ref, atol=5e-4)


def test_engine_rejects_unsupported_dtype_and_unknown_path(small):
    cfg, params, _, _ = small
    with pytest.raises(ValueError, match="compute dtypes"):
        ServingEngine(params, cfg.with_(compute_dtype="bfloat16"),
                      forward="int8_fused_full", device="cpu")
    with pytest.raises(ValueError, match="unknown forward path"):
        ServingEngine(params, cfg, forward="fused", device="cpu")


def test_sentinel_is_not_ported_yet(small):
    with pytest.raises(NotImplementedError, match="sentinel"):
        _engine(small, sentinel=True)


# -- the degradation ladder ---------------------------------------------

def test_compile_failure_demotes_and_fallback_serves(small):
    *_, x, ref = small
    inj = FaultInjector()
    inj.arm("compile", path="fused_full", times=1)
    eng = _engine(small, inj)
    out = eng.infer(x)
    np.testing.assert_allclose(out, ref, atol=5e-4)
    assert eng.active_path(eng.bucket_for(5)) == "sr_split"
    c = eng.health()["counters"]
    assert c["compile_failures"] == 1 and c["demotions"] == 1
    assert eng.health()["state"] == "degraded"


def test_nonfinite_output_demotes(small):
    *_, x, ref = small
    inj = FaultInjector()
    inj.arm("output_nan", path="fused_full", times=1)
    eng = _engine(small, inj)
    np.testing.assert_allclose(eng.infer(x), ref, atol=5e-4)
    assert eng.metrics.counter("nonfinite_batches") == 1


def test_stuck_dispatch_trips_the_watchdog(small):
    *_, x, ref = small
    inj = FaultInjector()
    inj.arm("stuck", path="fused_full", times=1, delay_s=5.0)
    eng = _engine(small, inj, watchdog_s=0.05)
    t0 = time.perf_counter()
    np.testing.assert_allclose(eng.infer(x), ref, atol=5e-4)
    assert time.perf_counter() - t0 < 2.0
    assert eng.metrics.counter("watchdog_timeouts") == 1


def test_async_realization_recovers_down_the_ladder(small):
    *_, x, ref = small
    inj = FaultInjector()
    inj.arm("output_nan", path="fused_full", times=1)
    eng = _engine(small, inj)
    rp = eng.infer(x, sync=False)
    np.testing.assert_allclose(rp.result(), ref, atol=5e-4)
    assert eng.metrics.counter("demotions") == 1
    assert eng.health()["inflight"] == 0


def test_whole_ladder_failure_is_down_not_raise(small):
    *_, x, _ = small
    inj = FaultInjector()
    inj.arm("dispatch")                          # every rung, forever
    inj.arm("compile")
    eng = _engine(small, inj)
    out = eng.infer(x)
    assert out.shape == (5, 5) and np.isnan(out).all()
    assert eng.health()["state"] == "down"
    with pytest.raises(RuntimeError, match="every rung"):
        eng.run_stream([x, x])


def test_backoff_probe_repromotes(small):
    *_, x, ref = small
    t = [0.0]
    inj = FaultInjector(clock=lambda: t[0])
    inj.arm("output_nan", path="fused_full", times=2)
    eng = _engine(small, inj, probe_initial_s=1.0, probe_max_s=8.0,
                  clock=lambda: t[0])
    bucket = eng.bucket_for(5)
    eng.infer(x)
    assert eng.active_path(bucket) == "sr_split"
    t[0] = 1.5
    eng.infer(x)                                 # probe burns fault 2
    assert eng.metrics.counter("probes") == 1
    t[0] = 4.0
    np.testing.assert_allclose(eng.infer(x), ref, atol=5e-4)
    assert eng.active_path(bucket) == "fused_full"
    assert eng.metrics.counter("promotions") == 1


def test_expired_request_is_shed(small):
    *_, x, _ = small
    t = [10.0]
    eng = _engine(small, clock=lambda: t[0])
    assert eng.infer(x, deadline=9.0) is None
    assert eng.metrics.counter("shed_events") == 5
    assert eng.health()["state"] == "shedding"


def test_async_inflight_is_bounded(small):
    *_, x, ref = small
    eng = _engine(small, max_inflight=2)
    handles = [eng.infer(x, sync=False) for _ in range(5)]
    assert eng.metrics.gauge_max("inflight") <= 2
    for h in handles:
        np.testing.assert_allclose(h.result(), ref, atol=5e-4)


def test_run_stream_demotes_on_compile_failure(small):
    *_, x, _ = small
    inj = FaultInjector()
    inj.arm("compile", path="fused_full", times=1)
    eng = _engine(small, inj)
    res = eng.run_stream([x] * 4, warmup=1)
    assert res["events"] == 15
    assert eng.active_path(res["bucket"]) == "sr_split"


# -- the readiness surface ----------------------------------------------

def test_device_result_and_stuck_buffer_readiness():
    r = DeviceResult(torch.ones(2, 3))
    assert r.is_ready() and r.synchronize() is r
    assert np.asarray(r).shape == (2, 3) and r.shape == (2, 3)
    t = [0.0]
    s = StuckBuffer(r, ready_at=1.0, clock=lambda: t[0])
    assert not s.is_ready()
    t[0] = 2.0
    assert s.is_ready() and np.asarray(s).sum() == 6


def test_serve_stream_warmup_and_metrics():
    m = ServingMetrics()
    lat, ev, wall = serve_stream(lambda x: x * 2,
                                 [np.ones((4, 2), np.float32)] * 5,
                                 warmup=2, metrics=m)
    assert len(lat) == 3 and ev == 12 and wall > 0 and m.batches == 3
    assert serve_stream(lambda x: x, [np.ones((1, 1))], warmup=3)[0] == []


# -- the CLI --------------------------------------------------------------

def test_cli_serves_on_cpu_and_reports(capsys):
    trigger_serve.main(["--device", "cpu", "--n-objects", "13",
                        "--batch", "8", "--batches", "4", "--health"])
    out = capsys.readouterr().out
    assert "forward=fused_full" in out and "device=cpu" in out
    assert "KGPS" in out and "p99" in out
    assert "serving    path=fused_full (chain fused_full>sr_split)" in out
    assert "[health] state=healthy" in out


def test_cli_drill_and_list_paths(capsys):
    trigger_serve.main(["--device", "cpu", "--n-objects", "13",
                        "--batch", "4", "--batches", "3",
                        "--drill", "compile:1"])
    out = capsys.readouterr().out
    assert "DRILL" in out and "compile_failures=1" in out
    trigger_serve.main(["--list-paths", "--batch", "64"])
    out = capsys.readouterr().out
    assert "int8_fused_full" in out and "bucket policy" in out


def test_make_stream_shapes():
    s = make_stream(np.random.RandomState(0), 3, 4, 13, 16)
    assert len(s) == 3 and s[0].shape == (4, 13, 16)
