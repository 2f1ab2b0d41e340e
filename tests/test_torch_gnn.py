"""The GNN zoo in the port against the JAX package on the CPU: gcn-cora,
pna, meshgraphnet and equiformer-v2 at ``test_gnn_smoke``'s reduction
(2 layers, width 16, l_max <= 2, m_max <= 1, heads <= 2), plus
equiformer-v2 at l_max 6, m_max 2 and C = 8, so every l of the full
config runs.

Bars: the init from a ``prng`` key within 4 ulps of ``jax.random``'s;
the forward on bridged weights within 2e-4 of max(1, max |out|) (fp32
sums in another order); the gradients of a scalar loss within 1e-4 of
each leaf's largest gradient, floored at 1e-4 of the tree's largest (a
leaf whose gradient vanishes in exact arithmetic holds rounding noise
only: the attention MLP's last bias, which the segment softmax ignores);
``_gnn_loss`` within 1e-6.  Equiformer-v2's invariances, chunked path
and SO(2) mix are in ``tests/test_torch_gnn_equiformer.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.models.gnn import GNN_MODULES as JMODS
from repro_torch import bridge
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.launch import steps as tsteps
from repro_torch.models.gnn import GNN_MODULES as TMODS

ARCHS = ["gcn-cora", "pna", "meshgraphnet", "equiformer-v2"]
N, E, D = 24, 72, 8


def _reduced(arch_id):
    full = jget_arch(arch_id).model
    return dataclasses.replace(full, n_layers=2, d_hidden=16,
                               l_max=min(full.l_max, 2),
                               m_max=min(full.m_max, 1),
                               n_heads=min(full.n_heads, 2) or 1)


#: (case id, reference config): the smoke reduction of each arch, and
#: equiformer-v2 with every l of the full config at a narrow width
CASES = {a: _reduced(a) for a in ARCHS}
CASES["equiformer-v2-l6"] = dataclasses.replace(
    jget_arch("equiformer-v2").model, n_layers=2, d_hidden=8, n_heads=2)


def _tcfg(jcfg):
    """The port's config with the reference's fields."""
    from repro_torch.configs.base import GNNConfig
    return GNNConfig(**dataclasses.asdict(jcfg))


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
    tree's largest)."""
    want = [np.asarray(a) for a in want]
    floor = 1e-4 * max(float(np.abs(a).max()) for a in want)
    for a, b in zip(want, got):
        scale = max(float(np.abs(a).max()), floor)
        assert float(np.abs(b.detach().numpy() - a).max()) <= 1e-4 * scale


@functools.lru_cache(maxsize=None)
def _japply(jcfg):
    """The reference's forward, jitted (its eager dispatch is slow)."""
    return jax.jit(lambda p, g: JMODS[jcfg.kind].apply(p, jcfg, g))


def _jinit(jcfg, d_in, n_out, seed=0):
    return jax.jit(lambda k: JMODS[jcfg.kind].init(k, jcfg, d_in, n_out))(
        jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def models():
    """Per case: (reference config, port config, reference params, port
    params bridged from them)."""
    out = {}
    for case, jcfg in CASES.items():
        jp = _jinit(jcfg, D, jcfg.n_classes)
        tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
        out[case] = (jcfg, _tcfg(jcfg), jp, tp)
    return out


def test_configs_equal_the_references():
    from repro.configs.base import GNN_SHAPES as JS
    from repro_torch.configs.base import GNN_SHAPES as TS
    assert list(TS) == list(JS)
    for name, shape in JS.items():
        assert dataclasses.asdict(TS[name]) == dataclasses.asdict(shape)
    for arch_id in ARCHS:
        t, j = tget_arch(arch_id), jget_arch(arch_id)
        assert t.family == j.family == "gnn"
        assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
        for f in ("arch_id", "source", "notes", "skipped_shapes"):
            assert getattr(t, f) == getattr(j, f)
        assert list(t.runnable_shapes()) == list(j.runnable_shapes())


@pytest.mark.parametrize("case", list(CASES))
def test_init_from_a_prng_key_replays_the_reference(case, models):
    jcfg, tcfg, jp, _ = models[case]
    tp = TMODS[tcfg.kind].init(prng.key(0), tcfg, D, tcfg.n_classes,
                               device="cpu")
    assert jax.tree_util.tree_structure(jp) \
        == jax.tree_util.tree_structure(bridge.params_to_numpy(tp))
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32
        ulps = np.abs(a.view(np.int32).astype(np.int64)
                      - b.numpy().view(np.int32).astype(np.int64)).max()
        assert ulps <= 4


@pytest.mark.parametrize("case", list(CASES))
def test_init_from_an_int_seed_draws_torchs_own(case, models):
    """An int seed draws from one ``torch.Generator``: the reference's
    tree and shapes, the same draws for the same seed, other values than
    the ``prng`` replay."""
    _, tcfg, jp, _ = models[case]
    init = TMODS[tcfg.kind].init
    a = init(0, tcfg, D, tcfg.n_classes, device="cpu")
    b = init(0, tcfg, D, tcfg.n_classes, device="cpu")
    assert jax.tree_util.tree_structure(bridge.params_to_numpy(a)) \
        == jax.tree_util.tree_structure(jp)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert [tuple(x.shape) for x in tree_leaves(a)] \
        == [np.asarray(x).shape for x in jax.tree_util.tree_leaves(jp)]
    assert any(not torch.equal(x, torch.from_numpy(np.array(y)))
               for x, y in zip(tree_leaves(a), jax.tree_util.tree_leaves(jp)))


@pytest.mark.parametrize("case", list(CASES))
def test_bridge_carries_the_tree_unchanged(case, models):
    """Nested lists of dicts and the (l_max+1, C, C) per-l leaves come
    through ``params_from_jax`` with their structure, shapes, dtypes and
    values, and ``params_to_numpy`` gives them back."""
    _, _, jp, tp = models[case]
    back = bridge.params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case, models):
    jcfg, tcfg, jp, tp = models[case]
    g = _graph(1)
    want = _japply(jcfg)(jp, _j(g))
    got = TMODS[tcfg.kind].apply(tp, tcfg, _t(g))
    assert got.shape == (N, tcfg.n_classes) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) \
        <= 2e-4 * _scale(want)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(case, models):
    jcfg, tcfg, jp, tp = models[case]
    g = _graph(2)
    fwd = _japply(jcfg)
    jg = jax.jit(jax.grad(lambda p: jnp.mean(jnp.square(fwd(p, _j(g))))))(jp)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    from repro_torch.common.tree import tree_unflatten
    out = TMODS[tcfg.kind].apply(tree_unflatten(tp, leaves), tcfg, _t(g))
    grads = torch.autograd.grad(out.square().mean(), leaves,
                                allow_unused=True, materialize_grads=True)
    _assert_grads_close(grads, jax.tree_util.tree_leaves(jg))


@pytest.mark.parametrize("kind,n_out,mask", [
    ("gcn", 5, False), ("pna", 7, False), ("meshgraphnet", 3, False),
    ("meshgraphnet", 3, True), ("equiformer_v2", 1, False),
    ("equiformer_v2", 1, True)])
def test_gnn_loss_matches_jax(kind, n_out, mask):
    """Cross-entropy with some labels -1 (masked out) and tied logits
    (argmax takes the first), or squared error over the ``seed_mask``
    nodes and over all of them."""
    rng = np.random.RandomState(3)
    out = rng.normal(0, 1, (30, n_out)).astype(np.float32)
    g = {}
    if kind in ("gcn", "pna"):
        g["y"] = rng.randint(-1, n_out, 30).astype(np.int32)
        out[:4] = 0.5                                   # tied rows
        g["y"][:4] = (0, 1, 0, 2)
    else:
        shape = (30,) if n_out == 1 else (30, n_out)
        g["y"] = rng.normal(0, 1, shape).astype(np.float32)
    if mask:
        g["seed_mask"] = rng.rand(30) < 0.4
    jl, jm = jsteps._gnn_loss(kind, None, jnp.asarray(out), _j(g))
    tl, tm = tsteps._gnn_loss(kind, None, torch.from_numpy(out), _t(g))
    assert sorted(tm) == sorted(jm)
    assert abs(float(tl) - float(jl)) <= 1e-6 * max(1.0, abs(float(jl)))
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6
    if kind in ("gcn", "pna"):
        assert 0.0 < float(tm["accuracy"]) < 1.0


def test_step_helpers_match_the_reference():
    from repro.configs.base import GNN_SHAPES
    from repro_torch.configs.base import GNN_SHAPES as TS
    for name, shape in GNN_SHAPES.items():
        assert tsteps._gnn_feat_dim(TS[name]) == jsteps._gnn_feat_dim(shape)
    for kind in ("gcn", "pna", "meshgraphnet", "equiformer_v2", "jedinet"):
        assert tsteps._needs_pos(kind) == jsteps._needs_pos(kind)
