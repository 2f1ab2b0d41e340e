"""Port parity of the JEDI-net forwards and the path registry.

Weights come from the JAX init (LeCun scale, as ``tests/test_fused_full.py``
uses, so logits sit at trained-model scale) and are carried across with
the bridge; inputs are ``make_jets`` from a numpy seed.  The bar is the
reference's own ``PathSpec.tolerance``: 2e-4 for the plain paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import interaction_net as jinet
from repro.core import paths as jpaths
from repro.data.jets import make_jets
from repro_torch import bridge
from repro_torch.configs import jedi_30p, jedi_50p, jedi_tracks_128
from repro_torch.core import interaction_net as tinet
from repro_torch.core import paths as tpaths

CFGS = {
    "30p": dict(n_objects=30),
    "13p-narrow": dict(n_objects=13, fr_hidden=(16, 12), fo_hidden=(10,),
                       phi_hidden=(12,)),
}


def _setup(name, batch, **kw):
    cfg_kw = dict(CFGS[name], **kw)
    jcfg = jinet.JediNetConfig(**cfg_kw)
    tcfg = tinet.JediNetConfig(**cfg_kw)
    jp = jax.tree_util.tree_map(
        np.asarray, jinet.init(jax.random.PRNGKey(0), jcfg, scale="lecun"))
    x, y = make_jets(np.random.RandomState(1), batch, jcfg.n_objects)
    return jcfg, tcfg, jp, bridge.params_from_jax(jp, device="cpu"), x, y


@pytest.mark.parametrize("cfg", list(CFGS))
@pytest.mark.parametrize("fwd", ["forward_dense", "forward_sr",
                                 "forward_sr_split"])
def test_plain_forwards_match_jax_fp32(cfg, fwd):
    jcfg, tcfg, jp, tp, x, _ = _setup(cfg, 3)
    want = np.asarray(getattr(jinet, fwd)(jp, jcfg, jnp.asarray(x)))
    got = getattr(tinet, fwd)(tp, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("model", ["jedi_50p", "jedi_tracks_128"])
@pytest.mark.parametrize("fwd", ["forward_sr", "forward_sr_split"])
def test_plain_forwards_match_jax_at_repo_configs(model, fwd):
    """The repo's wider configs at one event.  LeCun init puts an
    untrained jedi_tracks_128's logits near 1e3, where fp32 itself
    rounds at ~1e-4, so the 2e-4 bar applies to logits scaled to at
    least 1."""
    import importlib
    jmod = importlib.import_module(f"repro.configs.{model}")
    tmod = importlib.import_module(f"repro_torch.configs.{model}")
    jp = jax.tree_util.tree_map(np.asarray, jinet.init(
        jax.random.PRNGKey(0), jmod.MODEL, scale="lecun"))
    x, _ = make_jets(np.random.RandomState(1), 1, jmod.MODEL.n_objects)
    want = np.asarray(getattr(jinet, fwd)(jp, jmod.MODEL, jnp.asarray(x)))
    got = getattr(tinet, fwd)(bridge.params_from_jax(jp, device="cpu"),
                              tmod.MODEL, torch.from_numpy(x)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 2e-4 * scale


def test_sr_split_gather_variant_matches_jax():
    jcfg, tcfg, jp, tp, x, _ = _setup("13p-narrow", 2)
    want = np.asarray(jinet.forward_sr_split(jp, jcfg, jnp.asarray(x),
                                             grid=False))
    got = tinet.forward_sr_split(tp, tcfg, torch.from_numpy(x), grid=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("fwd", ["forward_sr", "forward_sr_split"])
def test_plain_forwards_match_jax_bf16(fwd):
    """bf16: both sides round at the same places, but fp32 sums taken in
    another order can flip a bf16 rounding (one ulp, 2^-8 relative) of
    an intermediate, which later layers carry: bound 2e-2 of the logit
    scale."""
    jcfg, tcfg, jp, tp, x, _ = _setup("30p", 2, compute_dtype="bfloat16")
    want = np.asarray(getattr(jinet, fwd)(jp, jcfg, jnp.asarray(x)))
    got = getattr(tinet, fwd)(tp, tcfg, torch.from_numpy(x)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 2e-2 * scale


def test_return_intermediates_shapes():
    _, tcfg, _, tp, x, _ = _setup("13p-narrow", 2)
    logits, mid = tinet.forward_sr(tp, tcfg, torch.from_numpy(x),
                                   return_intermediates=True)
    assert mid["b"].shape == (2, tcfg.n_edges, 32)
    assert mid["ebar"].shape == (2, 13, tcfg.d_e)
    assert logits.shape == (2, tcfg.n_targets)


def test_loss_fn_matches_jax():
    jcfg, tcfg, jp, tp, x, y = _setup("13p-narrow", 4)
    jl, jaux = jinet.loss_fn(jp, jcfg, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)})
    tl, taux = tinet.loss_fn(tp, tcfg, {"x": torch.from_numpy(x),
                                        "y": torch.from_numpy(y)})
    assert abs(float(jl) - float(tl)) < 1e-4
    assert float(jaux["accuracy"]) == float(taux["accuracy"])
    with pytest.warns(UserWarning, match="quantized"):
        tinet.loss_fn(tp, tcfg, {"x": torch.from_numpy(x),
                                 "y": torch.from_numpy(y)},
                      forward="int8_fused_full")


def test_configs_match_reference():
    from repro.configs import jedi_30p as j30, jedi_50p as j50
    from repro.configs import jedi_tracks_128 as j128
    for ref, port in ((j30, jedi_30p), (j50, jedi_50p),
                      (j128, jedi_tracks_128)):
        assert ref.MODEL.__dict__ == port.MODEL.__dict__


PORTED = ["dense", "sr", "sr_split", "fused", "fused_full",
          "int8_fused_full", "jedi_linear", "jedi_linear_full",
          "int8_jedi_linear_full"]


def test_registry_holds_the_ported_paths():
    assert tpaths.available() == sorted(PORTED) == jpaths.available()
    assert tpaths.available(cuda=True) == [
        "fused", "fused_full", "int8_fused_full", "int8_jedi_linear_full",
        "jedi_linear_full"]
    assert tpaths.available(quantized=True) == ["int8_fused_full",
                                                "int8_jedi_linear_full"]
    with pytest.raises(ValueError, match="available"):
        tpaths.get("fused_edge")


@pytest.mark.parametrize("name", PORTED)
def test_fallback_chains_equal_jax(name):
    assert tpaths.fallback_chain(name) == jpaths.fallback_chain(name)
    assert tpaths.terminal_rung(name) == jpaths.terminal_rung(name)
    ref, port = jpaths.get(name), tpaths.get(name)
    assert port.tolerance == ref.tolerance
    assert port.cuda == ref.pallas
    assert port.compute_dtypes == ref.compute_dtypes
    assert port.fused_level == ref.fused_level


def test_fallback_chain_rejects_cuda_terminal_and_cycles():
    spec = tpaths.get("fused_full")
    saved = dict(tpaths._REGISTRY)
    try:
        tpaths.register(tpaths.PathSpec(
            name="_k_only", forward=spec.forward, ref=spec.ref, cuda=True))
        with pytest.raises(ValueError, match="non-kernel"):
            tpaths.fallback_chain("_k_only")
        tpaths.register(tpaths.PathSpec(
            name="_a", forward=spec.forward, ref=spec.ref, fallback="_b"))
        tpaths.register(tpaths.PathSpec(
            name="_b", forward=spec.forward, ref=spec.ref, fallback="_a"))
        with pytest.raises(ValueError, match="cycles"):
            tpaths.fallback_chain("_a")
        with pytest.raises(ValueError, match="fused_level"):
            tpaths.PathSpec(name="_c", forward=spec.forward, ref=spec.ref,
                            fused_level="bogus")
    finally:
        tpaths._REGISTRY.clear()
        tpaths._REGISTRY.update(saved)
    assert set(tpaths.validate_fallbacks()) == set(PORTED)


def test_describe_lists_paths_chains_and_ladders():
    _, tcfg, _, tp, _, _ = _setup("30p", 1)
    text = tpaths.describe(cfg=tcfg, params=tp, max_batch=256)
    for name in PORTED:
        assert name in text
    assert "fused_full>sr_split" in text
    assert "8,16,32,64,128,256" in text
