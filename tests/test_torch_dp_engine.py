"""The data-parallel trigger engine: two shards on the CPU.

``serving/engine.py``'s ``shards`` (the counterpart of the reference's
``shard_map`` of a forward path over the batch axis of the local mesh):
a padded batch split into equal slices, each served by its own bound
callable, the outputs gathered onto the first shard's device.  Two
shards on one device hold the split and the gather on a machine with one
device; ``chip_smoke.py`` phase 11c runs the same on the card.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import interaction_net as jinet
from repro.serving.engine import TriggerWorkload as JaxTriggerWorkload
from repro_torch.bridge import params_from_jax
from repro_torch.core import interaction_net as inet
from repro_torch.core import paths
from repro_torch.data.jets import make_jets
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.resilient import ResilientEngine

CFG = inet.JediNetConfig(n_objects=8, n_features=16, fr_hidden=(8,),
                         fo_hidden=(8,), phi_hidden=(8,))


@pytest.mark.parametrize("forward", ["fused_full", "int8_fused_full",
                                     "jedi_linear_full"])
def test_two_shard_engine_matches_one_shard_and_the_reference(forward):
    """Two shards on the CPU: every bucket even, the logits those of the
    one-shard engine (each event's logits depend on that event alone, and
    the plain versions compute one event at a time) and within the path's
    tolerance of its reference."""
    params = inet.init(0, CFG, scale="lecun", device="cpu")
    one = ServingEngine(params, CFG, forward=forward, device="cpu",
                        max_batch=32)
    two = ServingEngine(params, CFG, forward=forward, device="cpu",
                        shards=["cpu", "cpu"], max_batch=32)
    assert one.n_shards == 1 and two.n_shards == 2
    assert all(b % 2 == 0 for b in two.bucket_sizes)
    assert two.bucket_sizes[-1] >= 32
    spec = paths.get(forward)
    x = make_jets(np.random.RandomState(3), 27, CFG.n_objects)[0]
    a, b = one.infer(x), two.infer(x)
    assert b.shape == (27, CFG.n_targets)
    np.testing.assert_array_equal(a, b)
    ref = spec.ref(spec.prepare_params(params), CFG, torch.from_numpy(x))
    scale = max(1.0, float(ref.abs().max()))
    assert float(np.abs(b - ref.numpy()).max()) <= spec.tolerance * scale
    top = two.bucket_sizes[-1]
    assert two.roofline([top])[top]["step_us"] == pytest.approx(
        one.roofline([top])[top]["step_us"] / 2)


def test_two_shard_resilient_engine_serves_a_stream():
    params = inet.init(0, CFG, scale="lecun", device="cpu")
    eng = ResilientEngine(params, CFG, device="cpu", shards=["cpu", "cpu"],
                          max_batch=16)
    assert eng.n_shards == 2
    stream = [make_jets(np.random.RandomState(i), 16, CFG.n_objects)[0]
              for i in range(5)]
    res = eng.run_stream(stream, warmup=1)
    assert res["bucket"] == 16 and len(res["latencies"]) == 4
    h = eng.health()
    assert h["state"] == "healthy" and not h["counters"]
    single = ResilientEngine(params, CFG, device="cpu", max_batch=16)
    np.testing.assert_array_equal(eng.infer(stream[0]),
                                  single.infer(stream[0]))


def test_validate_buckets_rejects_a_bucket_that_does_not_divide_the_shards():
    params = inet.init(0, CFG, device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        ServingEngine(params, CFG, device="cpu", shards=["cpu", "cpu"],
                      bucket_sizes=[16, 33])
    ServingEngine(params, CFG, device="cpu", bucket_sizes=[16, 33])


def test_silent_fault_seams_act_on_every_shard():
    """A corrupted build (the sentinel's seams) corrupts both halves of a
    two-shard batch."""
    params = inet.init(0, CFG, scale="lecun", device="cpu")
    eng = ServingEngine(params, CFG, device="cpu", shards=["cpu", "cpu"],
                        bucket_sizes=[16])
    x = torch.from_numpy(make_jets(np.random.RandomState(3), 16,
                                   CFG.n_objects)[0])
    clean = eng.compiled_for(16)(x)
    bad = eng.workload.corrupted("weight_corrupt", 4.0, 16)(x)
    moved = (bad - clean).abs().amax(-1)
    assert bool((moved[:8] > 0).any()) and bool((moved[8:] > 0).any())


@pytest.mark.parametrize("forward,n,max_batch",
                         [("sr_split", 100, 100), ("fused_full", 20, 64)])
def test_two_shard_engine_matches_the_jax_engine(forward, n, max_batch):
    """The reference's ``test_engine_shards_batch_axis_over_mesh`` with 2
    shards, on params bridged from the reference's init.  The ladder is
    what the reference workload's ``bucket_ladder`` makes at 2 shards
    (per-shard ladder for ``max_batch`` rounded up, then scaled) out of
    the port's per-shard ladder: each path's per-shard ladder comes from
    the H100 budget, not the TPU's, so at ``max_batch`` 100 its top rung
    differs.  Every bucket is even, the top one covers ``max_batch``, and
    the logits are within the path's tolerance of scale of the
    reference's ``forward_sr`` (the reference's absolute 1e-5 holds its
    own order of sums; logits here reach ~15)."""
    cfg = jinet.JediNetConfig(n_objects=30, n_features=16)
    jparams = jinet.init(jax.random.PRNGKey(0), cfg, scale="lecun")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (100, 30, 16)))
    want = np.asarray(jinet.forward_sr(jparams, cfg, jnp.asarray(x)))

    tcfg = inet.JediNetConfig(n_objects=30, n_features=16)
    eng = ServingEngine(params_from_jax(jparams, device="cpu"), tcfg,
                        forward=forward, device="cpu",
                        shards=["cpu", "cpu"], max_batch=max_batch)
    ref_wl = JaxTriggerWorkload(jparams, cfg, forward=forward, mesh=None)
    ref_wl.n_shards = 2     # the reference's scaling on a 2-device mesh
    ref_wl.spec = types.SimpleNamespace(
        bucket_ladder=lambda _cfg, _params, per_shard:
        eng.spec.bucket_ladder(tcfg, eng.params, per_shard))
    assert eng.n_shards == 2
    assert eng.bucket_sizes == sorted(ref_wl.bucket_ladder(max_batch))
    assert all(b % 2 == 0 for b in eng.bucket_sizes)
    assert eng.bucket_sizes[-1] >= max_batch
    got = eng.infer(x[:n])
    assert got.shape == want[:n].shape
    scale = max(1.0, float(np.abs(want[:n]).max()))
    assert float(np.abs(got - want[:n]).max()) <= \
        paths.get(forward).tolerance * scale
