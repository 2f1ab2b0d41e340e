"""The port's silent-corruption sentinel on ``device="cpu"``.

Mirrors every trigger case of ``tests/test_sentinel.py`` and the silent
drills of ``tests/test_faults.py`` on the port, with weights bridged
from the JAX reference, and holds the port's sentinel against the
reference's directly: the canary batch bitwise, each rung's golden
logits at the path's tolerance, and the rotating drill's detection and
requalification batches (EXPERIMENTS.md §Sentinel: 1 and 9).  The
kernel paths serve through their plain versions here.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import interaction_net as jinet
from repro.serving import ResilientEngine as JaxResilientEngine
from repro.serving import SentinelConfig as JaxSentinelConfig
from repro_torch import bridge
from repro_torch.core import interaction_net as tinet
from repro_torch.core import paths
from repro_torch.launch import trigger_serve
from repro_torch.serving import (
    FaultInjector,
    ResilientEngine,
    SentinelConfig,
    ServingMetrics,
)

#: (path, seam, factor): every silent seam, each on a path where the
#: corruption bites (scale_drift needs int8), and weight_corrupt on B2's
#: path too.
SILENT_CASES = [
    ("int8_fused_full", "scale_drift", 8.0),
    ("fused_full", "weight_corrupt", 8.0),
    ("fused_full", "stale_cache", 1.0),
    ("jedi_linear_full", "weight_corrupt", 8.0),
]

LOUD = ("compile_failures", "dispatch_failures", "nonfinite_batches",
        "watchdog_timeouts")


@pytest.fixture(scope="module")
def jedi8():
    jcfg = jinet.JediNetConfig(n_objects=8, n_features=16)
    jp = jax.tree_util.tree_map(
        np.asarray, jinet.init(jax.random.PRNGKey(0), jcfg, scale="lecun"))
    cfg = tinet.JediNetConfig(n_objects=8, n_features=16)
    params = bridge.params_from_jax(jp, device="cpu")
    x = np.random.RandomState(0).normal(0, 1, (5, 8, 16)).astype(np.float32)
    ref = np.asarray(jinet.forward_sr(jp, jcfg, jnp.asarray(x)))
    return cfg, params, x, ref, jcfg, jp


def _forward_sr(jedi, x):
    *_, jcfg, jp = jedi
    return np.asarray(jinet.forward_sr(jp, jcfg, jnp.asarray(x)))


def _engine(jedi, injector=None, sentinel=None, **kw):
    cfg, params = jedi[:2]
    kw.setdefault("forward", "fused_full")
    kw.setdefault("max_batch", 16)
    if sentinel is None:
        sentinel = SentinelConfig(canary_every=4, promote_after=2,
                                  shadow_rate=0.25, shadow_sync=True)
    return ResilientEngine(params, cfg, device="cpu", injector=injector,
                           sentinel=sentinel, **kw)


# -- the port against the reference --------------------------------------


@pytest.mark.parametrize("path", ["fused_full", "int8_fused_full",
                                  "jedi_linear_full"])
def test_canary_and_golden_table_match_the_reference(jedi8, path):
    """The same canary draw, bitwise, and per rung a golden within the
    rung's tolerance of the reference's golden (its ``ref`` in JAX)."""
    cfg, params, *_, jcfg, jp = jedi8
    want = JaxResilientEngine(jp, jcfg, forward=path, interpret=True,
                              max_batch=16,
                              sentinel=JaxSentinelConfig(seed=3)).sentinel
    got = _engine(jedi8, forward=path,
                  sentinel=SentinelConfig(seed=3)).sentinel
    np.testing.assert_array_equal(got._canary_x, want._canary_x)
    assert got._canary_x.dtype == np.float32
    assert sorted(got._golden) == sorted(want._golden)
    chain = paths.fallback_chain(path)
    for lvl, g in got._golden.items():
        tol = paths.get(chain[lvl]).tolerance
        np.testing.assert_allclose(g, np.asarray(want._golden[lvl]),
                                   rtol=0, atol=tol)
    for lvl, thr in got._shadow_thr.items():
        assert thr == pytest.approx(want._shadow_thr[lvl], rel=0.05)


def test_terminal_rung_resolves_chain_bottom():
    for name in paths.available():
        term = paths.terminal_rung(name)
        assert term == paths.fallback_chain(name)[-1]
        assert not paths.get(term).cuda


# -- canary detection -----------------------------------------------------


@pytest.mark.parametrize("path,seam,factor", SILENT_CASES)
def test_canary_detects_and_quarantines_each_silent_seam(
        jedi8, path, seam, factor):
    """Every silent seam is caught by the FIRST canary: one batch of
    detection latency, no exception, never a ``healthy`` report while
    the corruption serves."""
    cfg, _, x, *_ = jedi8
    inj = FaultInjector()
    inj.arm(seam, path=path, factor=factor)          # persistent corruption
    eng = _engine(jedi8, inj, forward=path)
    out = eng.infer(x)
    assert out.shape == (5, cfg.n_targets) and np.isfinite(out).all()
    h = eng.health()
    assert h["state"] == "quarantined"
    assert h["counters"]["sentinel_trips"] >= 1
    assert h["counters"]["quarantines"] == 1
    b = h["buckets"][eng.bucket_for(5)]
    assert b["quarantined"] and b["quarantined_path"] == path
    assert not any(k in h["counters"] for k in LOUD)


@pytest.mark.parametrize("path,seam,factor", SILENT_CASES)
def test_quarantine_requalifies_after_clean_canaries(jedi8, path, seam,
                                                     factor):
    """times=1: the trip evicts the poisoned entry (and the weights it
    bound), the rebuild is clean, and ``promote_after`` clean canaries
    re-promote."""
    _, _, x, *_ = jedi8
    inj = FaultInjector()
    inj.arm(seam, path=path, times=1, factor=factor)
    eng = _engine(jedi8, inj, forward=path)
    states = []
    for _ in range(12):
        out = eng.infer(x)
        assert np.isfinite(out).all()
        states.append(eng.health()["state"])
    assert states[0] == "quarantined"
    assert states[-1] == "healthy"
    first_healthy = states.index("healthy")
    assert all(s == "quarantined" for s in states[:first_healthy])
    c = eng.metrics.counters
    assert c["requalifications"] == 1
    assert c["canary_mismatches"] == 1
    assert eng.active_path(eng.bucket_for(5)) == path
    assert not any(k in c for k in LOUD)


def test_evict_drops_the_poisoned_callable(jedi8):
    """The corrupted twin binds its own weights: the cached entry serves
    wrong logits until evicted, and the rebuild serves the clean ones."""
    _, _, x, ref, *_ = jedi8
    inj = FaultInjector()
    inj.arm("weight_corrupt", path="fused_full", times=1, factor=8.0)
    eng = _engine(jedi8, inj, sentinel=False)._engine_for(0)
    bad = eng.infer(x)
    assert np.abs(bad - ref).max() > 1e-2
    np.testing.assert_array_equal(eng.infer(x), bad)     # cached: persists
    eng.evict(eng.bucket_for(5))
    assert eng.cache_size == 0
    np.testing.assert_allclose(eng.infer(x), ref, rtol=0, atol=5e-4)


def test_persistent_corruption_never_requalifies(jedi8):
    """times=inf: every rebuild re-corrupts, every requalification canary
    is dirty, and the clean fallback serves throughout."""
    _, _, x, ref, *_ = jedi8
    inj = FaultInjector()
    inj.arm("weight_corrupt", path="fused_full", factor=8.0)
    eng = _engine(jedi8, inj)
    eng.infer(x)
    assert eng.health()["state"] == "quarantined"
    for _ in range(15):
        out = eng.infer(x)
        assert np.abs(out - ref).max() < 1e-3
    h = eng.health()
    assert h["state"] == "quarantined"
    assert h["counters"]["sentinel_trips"] >= 2
    assert "requalifications" not in h["counters"]


def test_quarantined_bucket_never_probes_live_traffic(jedi8):
    _, _, x, *_ = jedi8
    t = [0.0]
    inj = FaultInjector()
    inj.arm("weight_corrupt", path="fused_full", factor=8.0)
    eng = _engine(jedi8, inj, clock=lambda: t[0], probe_initial_s=0.01)
    for _ in range(8):
        eng.infer(x)
        t[0] += 10.0
    assert eng.health()["state"] == "quarantined"
    assert "probes" not in eng.metrics.counters


# -- shadow re-execution --------------------------------------------------


def test_shadow_reexecution_feeds_agreement_stats(jedi8):
    _, _, x, *_ = jedi8
    eng = _engine(jedi8, sentinel=SentinelConfig(
        canary_every=100, shadow_rate=0.5, shadow_sync=True))
    for _ in range(8):
        eng.infer(x)
    m = eng.metrics
    b = eng.bucket_for(5)
    assert m.counter("shadow_requests") >= 3
    assert m.gauge_value(f"shadow_dev_ewma_b{b}") < 1e-2
    assert m.gauge_value(f"shadow_argmax_ewma_b{b}") == 0.0
    assert "shadow_disagreements" not in m.counters
    assert eng.health()["state"] == "healthy"


def test_shadow_trips_quarantine_when_canary_is_blind(jedi8):
    _, _, x, *_ = jedi8
    inj = FaultInjector()
    inj.arm("weight_corrupt", path="fused_full", factor=8.0)
    eng = _engine(jedi8, inj, sentinel=SentinelConfig(
        canary_every=1000, shadow_rate=1.0, shadow_sync=True))
    eng.sentinel._golden.clear()                     # blind the canaries
    for _ in range(4):
        eng.infer(x)
    h = eng.health()
    assert h["state"] == "quarantined"
    assert h["counters"]["shadow_disagreements"] >= 1
    assert h["counters"]["quarantines"] == 1


def test_shadow_worker_thread_applies_trips_on_serve_thread(jedi8):
    _, _, x, *_ = jedi8
    inj = FaultInjector()
    inj.arm("weight_corrupt", path="fused_full", factor=8.0)
    eng = _engine(jedi8, inj, sentinel=SentinelConfig(
        canary_every=1000, shadow_rate=1.0, shadow_sync=False))
    eng.sentinel._golden.clear()
    try:
        for _ in range(4):
            eng.infer(x)
        eng.sentinel.drain()
        assert eng.health()["state"] == "quarantined"
        assert eng.metrics.counter("shadow_requests") >= 1
        assert eng.sentinel.shadow_stream is None    # no stream off the card
    finally:
        eng.sentinel.close()


def test_async_shadows_leave_served_logits_unchanged(jedi8):
    """A clean stream with async shadows on every request: no
    disagreement, and the served logits equal a sentinel-free engine's."""
    _, _, x, *_ = jedi8
    rng = np.random.RandomState(5)
    xs = [rng.normal(0, 1, (5, 8, 16)).astype(np.float32) for _ in range(6)]
    eng = _engine(jedi8, sentinel=SentinelConfig(
        canary_every=2, shadow_rate=1.0, shadow_sync=False))
    plain = _engine(jedi8, sentinel=False)
    try:
        for xi in xs:
            np.testing.assert_array_equal(eng.infer(xi), plain.infer(xi))
        eng.sentinel.drain()
    finally:
        eng.sentinel.close()
    c = eng.metrics.counters
    assert c["shadow_requests"] == len(xs)
    assert "shadow_disagreements" not in c and "canary_mismatches" not in c


def test_quantized_rung_does_not_false_trip_against_fp32_oracle(jedi8):
    _, _, x, *_ = jedi8
    eng = _engine(jedi8, forward="int8_fused_full",
                  sentinel=SentinelConfig(canary_every=2, shadow_rate=0.5,
                                          shadow_sync=True))
    for _ in range(8):
        eng.infer(x)
    h = eng.health()
    assert h["state"] == "healthy"
    assert "shadow_disagreements" not in h["counters"]
    assert "canary_mismatches" not in h["counters"]
    assert h["counters"]["shadow_requests"] >= 2


# -- health surface -------------------------------------------------------


def test_health_reports_sentinel_detail(jedi8):
    eng = _engine(jedi8)
    eng.infer(jedi8[2])
    h = eng.health()
    s = h["sentinel"]
    assert s["canary_every"] == 4 and s["promote_after"] == 2
    assert s["golden_rungs"] == [0, 1]               # fused_full, sr_split
    b = h["buckets"][eng.bucket_for(5)]
    assert {"quarantined", "quarantined_path", "clean_canaries"} <= set(b)


def test_health_state_ordering_quarantined_beats_shedding(jedi8):
    _, _, x, *_ = jedi8
    inj = FaultInjector()
    inj.arm("weight_corrupt", path="fused_full", factor=8.0)
    eng = _engine(jedi8, inj)
    eng.infer(x)
    eng.infer(x, deadline=eng._clock() - 1.0)
    assert eng.metrics.counter("shed_requests") == 1
    assert eng.health()["state"] == "quarantined"


def test_sentinel_true_uses_default_config(jedi8):
    eng = _engine(jedi8, sentinel=True)
    assert eng.sentinel.config == SentinelConfig()
    assert _engine(jedi8, sentinel=False).sentinel is None


# -- silent drills (tests/test_faults.py) ---------------------------------


ROTATION = list(zip(("scale_drift", "weight_corrupt", "stale_cache"),
                    (8, 16, 32)))


def test_silent_seams_invisible_without_sentinel(jedi8):
    """The gap the sentinel closes: every silent seam strikes, finite and
    wrong, yet no loud detector fires and health reads ``healthy``."""
    cfg = jedi8[0]
    inj = FaultInjector()
    for seam, bucket in ROTATION:
        inj.arm(seam, path="int8_fused_full", bucket=bucket, factor=8.0)
    eng = _engine(jedi8, inj, forward="int8_fused_full", max_batch=64,
                  sentinel=False)
    rng = np.random.RandomState(7)
    worst = 0.0
    for _, bucket in ROTATION:
        for _ in range(4):
            n = bucket - 3
            x = rng.normal(0, 1, (n, 8, 16)).astype(np.float32)
            out = eng.infer(x)
            assert out.shape == (n, cfg.n_targets) and np.isfinite(out).all()
            worst = max(worst, float(np.abs(out - _forward_sr(jedi8, x)).max()))
    assert worst > 1.0
    assert inj.fired() == 3
    h = eng.health()
    assert h["state"] == "healthy"
    for k in (*LOUD, "demotions", "quarantines"):
        assert k not in h["counters"], k


def test_rotating_silent_seams_detected_at_1_requalified_at_9(jedi8):
    """EXPERIMENTS.md §Sentinel's drill (int8_fused_full, ladder
    [8, 16, 32, 64], one seam per bucket, canary_every=3,
    promote_after=2): each seam detected at live batch 1 and requalified
    at batch 9, with no exception and the fp32 fallback serving correct
    answers while quarantined."""
    inj = FaultInjector()
    for seam, bucket in ROTATION:
        inj.arm(seam, path="int8_fused_full", bucket=bucket, times=1,
                factor=8.0)
    eng = _engine(jedi8, inj, forward="int8_fused_full", max_batch=64,
                  sentinel=SentinelConfig(canary_every=3, promote_after=2,
                                          shadow_rate=0.25,
                                          shadow_sync=True))
    assert eng.bucket_sizes == [8, 16, 32, 64]
    rng = np.random.RandomState(11)
    for seam, bucket in ROTATION:
        n = bucket - 3
        states = []
        for _ in range(14):
            x = rng.normal(0, 1, (n, 8, 16)).astype(np.float32)
            served_by = eng.active_path(bucket)
            out = eng.infer(x)
            assert np.isfinite(out).all()
            if served_by != "int8_fused_full":
                assert np.abs(out - _forward_sr(jedi8, x)).max() < 1e-3
            states.append(eng.health()["state"])
        assert states[0] == "quarantined", seam          # detected at 1
        assert states.index("healthy") + 1 == 9, seam    # requalified at 9
        assert all(s == "quarantined" for s in states[:8]), seam
        assert all(s == "healthy" for s in states[8:]), seam
    c = eng.metrics.counters
    assert c["quarantines"] == 3 and c["requalifications"] == 3
    assert c["sentinel_trips"] == 3 and c["canary_mismatches"] == 3
    assert not any(k in c for k in LOUD)
    assert inj.fired() == 3


# -- stream verification and the CLI ---------------------------------------


def test_run_stream_verifies_post_hoc_and_catches_corruption(jedi8):
    _, _, x, *_ = jedi8
    inj = FaultInjector()
    inj.arm("weight_corrupt", path="fused_full", times=1, factor=8.0)
    eng = _engine(jedi8, inj, sentinel=SentinelConfig(
        canary_every=4, shadow_rate=0.5, shadow_sync=True))
    res = eng.run_stream([x] * 6, warmup=1)
    assert res["events"] == 25
    h = eng.health()
    assert h["state"] == "quarantined"
    assert h["counters"]["canaries"] >= 1
    assert h["counters"]["shadow_requests"] == 3
    assert eng.metrics.gauge_value("sentinel_verify_s") > 0


def test_cli_drill_with_sentinel_quarantines(capsys):
    trigger_serve.main(["--device", "cpu", "--n-objects", "8",
                        "--batch", "8", "--batches", "4",
                        "--forward", "int8_fused_full", "--sentinel",
                        "--canary-every", "3", "--drill", "scale_drift:1"])
    out = capsys.readouterr().out
    assert "state=quarantined" in out
    assert "QUARANTINED[int8_fused_full]" in out
    assert "sentinel: canary_every=3" in out and "canary_mismatches=1" in out


# -- metrics thread-safety -------------------------------------------------


def test_metrics_concurrent_increments_lose_nothing():
    m = ServingMetrics()
    n_threads, n_incr = 8, 2000

    def pump():
        for _ in range(n_incr):
            m.incr("shadow_requests")
            m.gauge("inflight", 1.0)

    threads = [threading.Thread(target=pump) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert m.counter("shadow_requests") == n_threads * n_incr
    assert m.gauge_max("inflight") == 1.0
