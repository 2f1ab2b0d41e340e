"""Port parity at the bottom layers: bridge, nn core, data, adjacency, int8.

The same inputs, made with numpy from a seed, go through the JAX
reference and the port; weights are initialised once in JAX and carried
across with ``repro_torch.bridge``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adjacency as jadj
from repro.core import int8_path as jint8
from repro.core import interaction_net as jinet
from repro.data import jets as jjets
from repro.nn import core as jnn
from repro_torch import bridge
from repro_torch.core import adjacency as tadj
from repro_torch.core import int8_path as tint8
from repro_torch.data import jets as tjets
from repro_torch.nn import core as tnn


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_bridge_keeps_layout_and_dtypes_and_round_trips():
    cfg = jinet.JediNetConfig(n_objects=6, fr_hidden=(7,), fo_hidden=(5,),
                              phi_hidden=(4,))
    jp = _np_tree(jinet.init(jax.random.PRNGKey(0), cfg))
    tp = bridge.params_from_jax(jp, device="cpu")
    w = tp["fr"]["layers"][0]["w"]
    assert w.dtype == torch.float32 and tuple(w.shape) == (32, 7)
    back = bridge.params_to_numpy(tp)
    for name in jp:
        for a, b in zip(jp[name]["layers"], back[name]["layers"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    q = _np_tree(jint8.quantize_params_int8(jp))
    tq = bridge.params_from_jax(q, device="cpu")
    assert tq["fo"]["layers"][0]["w"].dtype == torch.int8
    assert tq["fo"]["layers"][0]["w_scale"].shape == ()


@pytest.mark.parametrize("act", list(jnn.ACTIVATIONS))
def test_activations_match_jax(act):
    assert list(tnn.ACTIVATIONS) == list(jnn.ACTIVATIONS)
    x = np.random.RandomState(0).normal(0, 3, (257,)).astype(np.float32)
    want = np.asarray(jnn.ACTIVATIONS[act](jnp.asarray(x)))
    got = tnn.ACTIVATIONS[act](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("bfloat16", 0.0)])
def test_mlp_apply_matches_jax(dtype, tol):
    """fp32 to rounding; bf16 bit-equal: both take exact products of the
    same bf16 operands, fp32 sums over 16 terms, and round at the same
    places (after each product and after each bias add)."""
    rng = np.random.RandomState(3)
    jp = _np_tree(jnn.mlp_init(jax.random.PRNGKey(1), 16, (20, 20), 8,
                               scale="lecun"))
    x = rng.normal(0, 1, (5, 16)).astype(np.float32)
    want = np.asarray(jnn.mlp_apply(jp, jnp.asarray(x),
                                    compute_dtype=jnp.dtype(dtype)),
                      np.float32)
    tp = bridge.params_from_jax(jp, device="cpu")
    got = tnn.mlp_apply(tp, torch.from_numpy(x),
                        compute_dtype=dtype).float().numpy()
    if tol == 0.0:
        # sums of 16-20 products can differ in their last fp32 bit, which
        # can flip a bf16 rounding: allow one bf16 ulp of the output
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("scale", ["fan_in", "lecun", "fan_avg"])
def test_mlp_init_scale_rules(scale):
    gen = torch.Generator().manual_seed(0)
    p = tnn.mlp_init(gen, 400, (300,), 200, scale=scale)
    w0 = p["layers"][0]["w"]
    want = {"fan_in": (2 / 400) ** 0.5, "lecun": (1 / 400) ** 0.5,
            "fan_avg": (2 / 700) ** 0.5}[scale]
    assert abs(float(w0.std()) - want) < 0.03 * want
    assert torch.all(p["layers"][0]["b"] == 0)
    with pytest.raises(ValueError):
        tnn.mlp_init(gen, 4, (), 2, scale="bogus")


@pytest.mark.parametrize("seed,n,n_o", [(0, 7, 30), (5, 3, 13), (9, 2, 50)])
def test_make_jets_byte_identical(seed, n, n_o):
    xj, yj = jjets.make_jets(np.random.RandomState(seed), n, n_o)
    xt, yt = tjets.make_jets(np.random.RandomState(seed), n, n_o)
    assert xj.tobytes() == xt.tobytes() and yj.tobytes() == yt.tobytes()


def test_make_tracks_byte_identical():
    xj, yj = jjets.make_tracks(np.random.RandomState(2), 2, n_tracks=40)
    xt, yt = tjets.make_tracks(np.random.RandomState(2), 2, n_tracks=40)
    assert xj.tobytes() == xt.tobytes() and yj.tobytes() == yt.tobytes()


@pytest.mark.parametrize("n_o", [2, 13, 30])
def test_adjacency_matches_reference(n_o):
    for a, b in zip(jadj.edge_index_maps(n_o), tadj.edge_index_maps(n_o)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jadj.dense_relation_matrices(n_o),
                    tadj.dense_relation_matrices(n_o)):
        np.testing.assert_array_equal(a, b)
    assert jadj.mmm_op_counts(n_o, 16, 8) == tadj.mmm_op_counts(n_o, 16, 8)


def test_quantize_params_int8_bit_equal_to_jax():
    cfg = jinet.JediNetConfig(n_objects=13, fr_hidden=(16, 12),
                              fo_hidden=(10,))
    jp = _np_tree(jinet.init(jax.random.PRNGKey(4), cfg))
    jq = _np_tree(jint8.quantize_params_int8(jp))
    tq = tint8.quantize_params_int8(bridge.params_from_jax(jp, device="cpu"))
    for name in jq:
        for a, b in zip(jq[name]["layers"], tq[name]["layers"]):
            assert b["w"].dtype == torch.int8
            np.testing.assert_array_equal(a["w"], b["w"].numpy())
            assert np.float32(a["w_scale"]).tobytes() \
                == b["w_scale"].numpy().tobytes()
            np.testing.assert_array_equal(a["b"], b["b"].numpy())
    jd = _np_tree(jint8.dequantize_params(jq))
    td = tint8.dequantize_params(tq)
    for name in jd:
        for a, b in zip(jd[name]["layers"], td[name]["layers"]):
            np.testing.assert_array_equal(a["w"], b["w"].numpy())
