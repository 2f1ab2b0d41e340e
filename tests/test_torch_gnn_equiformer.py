"""EquiformerV2 in the port against the JAX package on the CPU, at
l_max 6, m_max 2, C = 8 and 2 layers (every l of the full config): the
readout invariant under a rotation of ``pos`` within 5e-3 and a
translation within 5e-4 (the reference test's bars,
``tests/test_equiformer.py``), the chunked edge path within 2e-4 of the
direct one and of the reference's (its gradients within 1e-4 of each
leaf's scale), the SO(2) mix's m-truncation, the population variance of
its norms, and its helpers.

The weights are the port's ``init(prng.key(0))``, which replays the
reference's within 4 ulps (``tests/test_torch_gnn.py``), carried to the
reference through numpy.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models.gnn import equiformer_v2 as jeq
from repro.models.gnn import so3 as jso3
from repro_torch import bridge
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves, tree_unflatten
from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import equiformer_v2 as teq
from repro_torch.models.gnn import so3 as tso3

N, E, D = 24, 72, 8
JCFG = dataclasses.replace(jget_arch("equiformer-v2").model, n_layers=2,
                           d_hidden=8, n_heads=2)
TCFG = GNNConfig(**dataclasses.asdict(JCFG))


def _graph(seed=0, n=N, e=E, d=D):
    rng = np.random.RandomState(seed)
    return {
        "x": rng.normal(0, 1, (n, d)).astype(np.float32),
        "senders": rng.randint(0, n, e).astype(np.int32),
        "receivers": rng.randint(0, n, e).astype(np.int32),
        "pos": rng.normal(0, 1, (n, 3)).astype(np.float32),
    }


def _j(g):
    return {k: jnp.asarray(v) for k, v in g.items()}


def _t(g):
    return {k: torch.from_numpy(v) for k, v in g.items()}


def _scale(a):
    return max(1.0, float(np.abs(np.asarray(a)).max()))


def _assert_grads_close(got, want):
    """Each leaf within 1e-4 of max(its largest gradient, 1e-4 of the
    tree's largest): the attention MLP's last bias has a zero gradient in
    exact arithmetic (the segment softmax ignores it) and holds rounding
    noise only."""
    want = [np.asarray(a) for a in want]
    floor = 1e-4 * max(float(np.abs(a).max()) for a in want)
    for a, b in zip(want, got):
        scale = max(float(np.abs(a).max()), floor)
        assert float(np.abs(b.detach().numpy() - a).max()) <= 1e-4 * scale


@pytest.fixture(scope="module")
def params():
    """(the port's params, the same values as the reference's arrays)."""
    tp = teq.init(prng.key(0), TCFG, D, TCFG.n_classes, device="cpu")
    return tp, jax.tree_util.tree_map(jnp.asarray,
                                      bridge.params_to_numpy(tp))


def _eq_out(params, g, **cfg_changes):
    cfg = dataclasses.replace(TCFG, **cfg_changes)
    return teq.apply(params[0], cfg, _t(g)).numpy()


def test_equiformer_readout_is_rotation_invariant(params):
    g = _graph(4)
    out = _eq_out(params, g)
    rot = tso3.rotation_matrices(torch.tensor([0.3, -1.1, 0.7])).numpy()
    out_rot = _eq_out(params, dict(g, pos=(g["pos"] @ rot.T).astype(
        np.float32)))
    np.testing.assert_allclose(out, out_rot, rtol=5e-3, atol=5e-3)


def test_equiformer_translation_invariance(params):
    g = _graph(5)
    out = _eq_out(params, g)
    shifted = dict(g, pos=g["pos"] + np.float32([10.0, -3.0, 2.0]))
    np.testing.assert_allclose(out, _eq_out(params, shifted),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("chunk", [16, 20])
def test_equiformer_chunked_path_matches_the_direct_one(params, chunk):
    """``cfg.edge_chunk`` below E runs the Python loop over edge chunks
    (72 edges: 5 chunks of 16, the last of 8; or 4 of 20, the last of 12),
    against the direct path and the reference's direct path."""
    g = _graph(6)
    direct = _eq_out(params, g)
    chunked = _eq_out(params, g, edge_chunk=chunk)
    np.testing.assert_allclose(chunked, direct, rtol=2e-4, atol=2e-4)
    want = np.asarray(jax.jit(lambda p, g: jeq.apply(p, JCFG, g))(
        params[1], _j(g)))
    assert float(np.abs(chunked - want).max()) <= 2e-4 * _scale(want)


def test_equiformer_chunked_path_trains_like_the_direct_one(params):
    tp = params[0]
    g = _t(_graph(7))

    def grads(cfg):
        leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
        out = teq.apply(tree_unflatten(tp, leaves), cfg, g)
        return torch.autograd.grad(out.square().mean(), leaves)

    _assert_grads_close(grads(dataclasses.replace(TCFG, edge_chunk=16)),
                        [a.numpy() for a in grads(TCFG)])


@pytest.mark.parametrize("m_max", [0, 1, 2])
def test_so2_conv_respects_m_truncation(m_max):
    """In the full layout, the components with |m| > m_max are zero, and
    the rest equal the reference's ``_so2_conv``."""
    jcfg = dataclasses.replace(JCFG, l_max=3, m_max=m_max)
    tcfg = GNNConfig(**dataclasses.asdict(jcfg))
    tp = teq.init(prng.key(1), tcfg, 5, 2, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.params_to_numpy(tp))
    rng = np.random.RandomState(8)
    k, c = (jcfg.l_max + 1) ** 2, jcfg.d_hidden
    x_rot = rng.normal(0, 1, (6, k, c)).astype(np.float32)
    gates = rng.normal(0, 1, (6, m_max + 1, c)).astype(np.float32)
    conv = jax.jit(functools.partial(jeq._so2_conv, cfg=jcfg),
                   static_argnames="truncated")
    want = conv(jp["gnn_layers"][0], x_rot=jnp.asarray(x_rot),
                gates=jnp.asarray(gates))
    got = teq._so2_conv(tp["gnn_layers"][0], tcfg, torch.from_numpy(x_rot),
                        torch.from_numpy(gates)).numpy()
    assert float(np.abs(got - np.asarray(want)).max()) <= 1e-5 * _scale(want)
    for l in range(jcfg.l_max + 1):
        for m in range(-l, l + 1):
            if abs(m) > m_max:
                assert np.all(got[:, tso3.flat_index(l, m), :] == 0), (l, m)
    # the truncated layout holds the same live rows
    size = tso3.truncated_size(jcfg.l_max, m_max)
    xt = rng.normal(0, 1, (6, size, c)).astype(np.float32)
    _close_trunc = teq._so2_conv(tp["gnn_layers"][0], tcfg,
                                 torch.from_numpy(xt),
                                 torch.from_numpy(gates), truncated=True)
    want_t = conv(jp["gnn_layers"][0], x_rot=jnp.asarray(xt),
                  gates=jnp.asarray(gates), truncated=True)
    assert float(np.abs(_close_trunc.numpy() - np.asarray(want_t)).max()) \
        <= 1e-5 * _scale(want_t)


def test_equivariant_ln_takes_the_population_variance():
    """``_equivariant_ln`` and ``nn.core.layernorm_apply`` against the
    reference: ``jnp.var`` divides by n, ``torch.var`` by n - 1 unless
    told otherwise (a 1/8 gap in the variance at C = 8)."""
    from repro.nn import core as jnn
    from repro_torch.nn import core as tnn
    rng = np.random.RandomState(9)
    h = (rng.normal(0, 1, (5, 16, 8)) * 3 + 1).astype(np.float32)
    scale = rng.normal(1, 0.1, (4, 8)).astype(np.float32)
    want = jeq._equivariant_ln(jnp.asarray(scale), 3, jnp.asarray(h))
    got = teq._equivariant_ln(torch.from_numpy(scale), 3, torch.from_numpy(h))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-5 * \
        _scale(want)
    p = {"scale": scale[0], "bias": scale[1]}
    want = jnn.layernorm_apply(_j(p), jnp.asarray(h))
    got = tnn.layernorm_apply(_t(p), torch.from_numpy(h))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-5 * \
        _scale(want)
    tp = tnn.layernorm_init(8, device="cpu")
    jp = jnn.layernorm_init(8)
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_equiformer_helpers_match_the_reference():
    rng = np.random.RandomState(10)
    dist = rng.uniform(0, 6, 40).astype(np.float32)
    want = jeq._rbf(jnp.asarray(dist))
    got = teq._rbf(torch.from_numpy(dist)).numpy()
    assert float(np.abs(got - np.asarray(want)).max()) <= 1e-6
    per_l = rng.normal(0, 1, (3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        teq._expand_l(torch.from_numpy(per_l), 4).numpy(),
        np.asarray(jeq._expand_l(jnp.asarray(per_l), 4)))
    w = rng.normal(0, 1, (5, 5, 5)).astype(np.float32)
    h = rng.normal(0, 1, (3, 25, 5)).astype(np.float32)
    want = jeq._per_l_mix(jnp.asarray(w), 4, jnp.asarray(h))
    got = teq._per_l_mix(torch.from_numpy(w), 4, torch.from_numpy(h))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-5 * \
        _scale(want)
    assert teq._m_l_counts(6, 2) == jeq._m_l_counts(6, 2)
    assert jso3.truncated_size(6, 2) == tso3.truncated_size(6, 2) == 29
