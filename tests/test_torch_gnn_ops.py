"""The GNN zoo's substrate in the port against the JAX package on the CPU:
the segment ops (``models/gnn/segment_ops.py``), the SO(3) machinery
(``models/gnn/so3.py``) and the numpy data copies (``data/graphs.py``,
``data/neighbor_sampler.py``), on the same seeded numpy inputs.

Bars: the numpy generators' arrays exactly; sums, means and softmaxes in
fp32 within 1e-6 of their scale (the reduction order differs); max and
min exactly, their gradients within an ulp, ties included; the spherical
harmonics and Wigner blocks within 1e-5 (fp32 recurrences and small
matmuls, ~1e-7 apart measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graphs as jgraphs
from repro.data import neighbor_sampler as jns
from repro.models.gnn import segment_ops as jseg
from repro.models.gnn import so3 as jso3
from repro_torch.data import graphs as tgraphs
from repro_torch.data import neighbor_sampler as tns
from repro_torch.models.gnn import segment_ops as tseg
from repro_torch.models.gnn import so3 as tso3


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _msgs(rng, e=40, d=3, relu=False):
    m = rng.normal(0, 1, (e, d)).astype(np.float32)
    return np.maximum(m, 0) if relu else m


# ---- segment ops ------------------------------------------------------------

@pytest.mark.parametrize("name", ["sum", "mean", "max", "min", "std"])
@pytest.mark.parametrize("relu", [False, True])
def test_scatter_matches_jax_with_empty_segments(name, relu):
    """Segment ids over 0..n-1 with n = 12 and only ids < 9 used: three
    empty segments (0 for max / min, as the reference maps -inf)."""
    rng = np.random.RandomState(3)
    m = _msgs(rng, relu=relu)
    ids = rng.randint(0, 9, m.shape[0]).astype(np.int32)
    want = jseg.SCATTER[name](jnp.asarray(m), jnp.asarray(ids), 12)
    got = tseg.SCATTER[name](torch.from_numpy(m), torch.from_numpy(ids), 12)
    if name in ("max", "min"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, 1e-6)
    assert np.all(np.asarray(want)[9:] == got.numpy()[9:])
    if name in ("max", "min", "sum", "mean"):
        assert np.all(got.numpy()[9:] == 0)


@pytest.mark.parametrize("name", ["sum", "mean", "max", "min", "std"])
def test_scatter_gradients_match_jax_with_ties(name):
    """ReLU messages (many ties at 0, segments all 0 among them) and
    repeated rows: the gradient of sum(w * scatter(m)) against the
    reference's; for max / min, which split a gradient evenly among tied
    messages, within 3e-7 relative (an ulp of the division: a share of
    w / 3 for w / 2 would be off by a third)."""
    rng = np.random.RandomState(4)
    m = _msgs(rng, e=48, d=2, relu=True)
    m[5:9] = m[4]                                  # exact ties, one segment
    ids = rng.randint(0, 10, m.shape[0]).astype(np.int32)
    ids[4:9] = 2
    w = rng.normal(0, 1, (12, 2)).astype(np.float32)

    def jloss(x):
        return jnp.sum(jnp.asarray(w) * jseg.SCATTER[name](
            x, jnp.asarray(ids), 12))

    want = jax.grad(jloss)(jnp.asarray(m))
    x = torch.from_numpy(m).requires_grad_(True)
    (torch.from_numpy(w) * tseg.SCATTER[name](
        x, torch.from_numpy(ids), 12)).sum().backward()
    if name in ("max", "min"):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                                   rtol=3e-7, atol=0)
    else:
        _close(x.grad, want, 1e-6)


def test_max_gradient_splits_evenly_among_ties():
    """The case both frameworks agree on: values [1, 1, 0.5 | 2]."""
    vals = np.array([[1.0], [1.0], [0.5], [2.0]], np.float32)
    ids = np.array([0, 0, 0, 1], np.int32)
    want = jax.grad(lambda v: jnp.sum(jseg.scatter_max(
        v, jnp.asarray(ids), 2)))(jnp.asarray(vals))
    x = torch.from_numpy(vals).requires_grad_(True)
    tseg.scatter_max(x, torch.from_numpy(ids), 2).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy()[:, 0], [0.5, 0.5, 0.0, 1.0])
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


def test_gather_and_degrees_match_jax():
    rng = np.random.RandomState(5)
    x = rng.normal(0, 1, (9, 4, 2)).astype(np.float32)
    idx = rng.randint(0, 9, 30).astype(np.int32)
    np.testing.assert_array_equal(
        tseg.gather(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
        np.asarray(jseg.gather(jnp.asarray(x), jnp.asarray(idx))))
    for dtype, tdtype in ((jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)):
        want = jseg.degrees(jnp.asarray(idx), 11, dtype)
        got = tseg.degrees(torch.from_numpy(idx), 11, tdtype)
        assert got.dtype == tdtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    # int64 ids give the same
    np.testing.assert_array_equal(
        tseg.degrees(torch.from_numpy(idx).long(), 11).numpy(),
        np.asarray(jseg.degrees(jnp.asarray(idx), 11)))


@pytest.mark.parametrize("shape", [(50,), (50, 4)])
def test_segment_softmax_matches_jax(shape):
    rng = np.random.RandomState(6)
    sc = (rng.normal(0, 3, shape)).astype(np.float32)
    ids = rng.randint(0, 13, shape[0]).astype(np.int32)
    want = jseg.segment_softmax(jnp.asarray(sc), jnp.asarray(ids), 15)
    x = torch.from_numpy(sc).requires_grad_(True)
    got = tseg.segment_softmax(x, torch.from_numpy(ids), 15)
    _close(got, want, 1e-6)
    sums = tseg.scatter_sum(got.detach(), torch.from_numpy(ids), 15)
    used = np.isin(np.arange(15), ids)
    np.testing.assert_allclose(sums.numpy()[used], 1.0, atol=1e-6)
    w = rng.normal(0, 1, shape).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * jseg.segment_softmax(
        v, jnp.asarray(ids), 15)))(jnp.asarray(sc))
    (got * torch.from_numpy(w)).sum().backward()
    _close(x.grad, jg, 1e-6)


def test_flatten_batched_graphs_matches_jax():
    g = jgraphs.molecule_batch(2, 5, 7, 11, 3)
    want = jseg.flatten_batched_graphs(jnp.asarray(g["x"]),
                                       jnp.asarray(g["senders"]),
                                       jnp.asarray(g["receivers"]))
    got = tseg.flatten_batched_graphs(torch.from_numpy(g["x"]),
                                      torch.from_numpy(g["senders"]),
                                      torch.from_numpy(g["receivers"]))
    for a, b in zip(got, want):
        assert a.dtype == getattr(torch, str(np.asarray(b).dtype))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---- so3 ---------------------------------------------------------------------

def _dirs(rng, n=20):
    d = rng.normal(0, 1, (n, 3))
    d[0] = (0.0, 0.0, 1.0)                         # the pole
    d[1] = (0.0, 0.0, -1.0)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("l_max", [0, 2, 6])
def test_real_sph_harm_matches_jax(l_max):
    d = _dirs(np.random.RandomState(l_max))
    want = jso3.real_sph_harm(l_max, jnp.asarray(d))
    got = tso3.real_sph_harm(l_max, torch.from_numpy(d))
    assert got.shape == (20, tso3.num_coeffs(l_max))
    _close(got, want, 1e-5)
    # the numpy branch (the oracle's constants) is the reference's
    np.testing.assert_array_equal(
        tso3.real_sph_harm(l_max, d.astype(np.float64)),
        jso3.real_sph_harm(l_max, d.astype(np.float64), xp=np))


def test_constants_equal_the_references():
    for l_max in (2, 6):
        np.testing.assert_array_equal(tso3._sample_dirs(l_max),
                                      jso3._sample_dirs(l_max))
        for a, b in zip(tso3._sh_pinv(l_max), jso3._sh_pinv(l_max)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tso3.j_matrices(l_max), jso3.j_matrices(l_max)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a @ a, np.eye(len(a)), atol=1e-9)


def test_wigner_blocks_match_jax_and_rotate_the_harmonics():
    rng = np.random.RandomState(7)
    l_max = 6
    aa = rng.normal(0, 1, (5, 3)).astype(np.float32)
    rot_t = tso3.rotation_matrices(torch.from_numpy(aa))
    rot_j = jso3.rotation_matrices(jnp.asarray(aa))
    _close(rot_t, rot_j, 1e-6)
    for a, b in zip(tso3.wigner_solve(l_max, rot_t),
                    jso3.wigner_solve(l_max, rot_j)):
        _close(a, b, 1e-5)
    d = _dirs(rng)
    for a, b in zip(tso3.wigner_align_z(l_max, torch.from_numpy(d)),
                    jso3.wigner_align_z(l_max, jnp.asarray(d))):
        _close(a, b, 1e-5)
    ang = rng.uniform(-4, 4, 9).astype(np.float32)
    for a, b in zip(tso3._dz_blocks(l_max, torch.from_numpy(ang)),
                    jso3._dz_blocks(l_max, jnp.asarray(ang))):
        _close(a, b, 1e-6)
    # D(dir -> z) takes Y(dir) to Y(+z)
    d64 = torch.from_numpy(d).double()
    d64 = d64 / torch.linalg.vector_norm(d64, dim=-1, keepdim=True)
    blocks = tso3.wigner_align_z(l_max, d64)
    y = tso3.real_sph_harm(l_max, d64)
    ez = tso3.real_sph_harm(l_max, torch.tensor([[0.0, 0.0, 1.0]],
                                                dtype=torch.float64))
    for l, blk in enumerate(blocks):
        sl = slice(l * l, (l + 1) ** 2)
        got = (blk @ y[:, sl, None])[..., 0]
        np.testing.assert_allclose(got.numpy(),
                                   np.broadcast_to(ez[:, sl].numpy(),
                                                   got.shape), atol=1e-9)


def test_wigner_blocks_need_nothing_the_autograd_graph_overwrites():
    """The per-edge blocks are built without in-place writes, so their
    gradient reaches the angles: d/d(ang) of D^l(Rz(ang)) vs JAX."""
    rng = np.random.RandomState(8)
    ang = rng.uniform(-3, 3, 6).astype(np.float32)
    w = [rng.normal(0, 1, (6, 2 * l + 1, 2 * l + 1)).astype(np.float32)
         for l in range(4)]
    jg = jax.grad(lambda a: sum(jnp.sum(jnp.asarray(wl) * b) for wl, b in zip(
        w, jso3._dz_blocks(3, a))))(jnp.asarray(ang))
    x = torch.from_numpy(ang).requires_grad_(True)
    sum((torch.from_numpy(wl) * b).sum() for wl, b in zip(
        w, tso3._dz_blocks(3, x))).backward()
    _close(x.grad, jg, 1e-5)


@pytest.mark.parametrize("transpose", [False, True])
def test_apply_wigner_and_its_truncated_forms_match_jax(transpose):
    rng = np.random.RandomState(9)
    l_max, m_max = 6, 2
    d = _dirs(rng, 7)
    feats = rng.normal(0, 1, (7, tso3.num_coeffs(l_max), 5)).astype(
        np.float32)
    tb = tso3.wigner_align_z(l_max, torch.from_numpy(d))
    jb = jso3.wigner_align_z(l_max, jnp.asarray(d))
    _close(tso3.apply_wigner(tb, torch.from_numpy(feats),
                             transpose=transpose),
           jso3.apply_wigner(jb, jnp.asarray(feats), transpose=transpose),
           1e-5)
    tt = tso3.apply_wigner_truncated(tb, torch.from_numpy(feats), m_max)
    jt = jso3.apply_wigner_truncated(jb, jnp.asarray(feats), m_max)
    assert tt.shape[1] == tso3.truncated_size(l_max, m_max) == 29
    _close(tt, jt, 1e-5)
    _close(tso3.apply_wigner_expand(tb, tt, m_max),
           jso3.apply_wigner_expand(jb, jt, m_max), 1e-5)


def test_truncated_layout_matches_the_reference():
    for l_max in range(7):
        for m_max in range(l_max + 1):
            assert tso3.truncated_size(l_max, m_max) \
                == jso3.truncated_size(l_max, m_max)
            seen = set()
            for l in range(l_max + 1):
                for m in range(-min(l, m_max), min(l, m_max) + 1):
                    i = tso3.truncated_index(l, m, l_max, m_max)
                    assert i == jso3.truncated_index(l, m, l_max, m_max)
                    seen.add(i)
            assert seen == set(range(tso3.truncated_size(l_max, m_max)))
    with pytest.raises(ValueError, match="m_max"):
        tso3.truncated_index(3, 3, 6, 2)


# ---- data copies -------------------------------------------------------------

def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_graph_generators_equal_the_reference(seed):
    _equal(tgraphs.community_graph(seed, 300, 1200, 16, n_classes=5),
           jgraphs.community_graph(seed, 300, 1200, 16, n_classes=5))
    _equal(tgraphs.mesh_graph(seed, 400, 900, 6),
           jgraphs.mesh_graph(seed, 400, 900, 6))
    _equal(tgraphs.molecule_batch(seed, 4, 30, 64, 16),
           jgraphs.molecule_batch(seed, 4, 30, 64, 16))


@pytest.mark.parametrize("seed", [0, 3])
def test_neighbor_sampler_equals_the_reference(seed):
    g = jgraphs.community_graph(seed, 500, 4000, 8, n_classes=3)
    assert tns.static_budget(16, (5, 3)) == jns.static_budget(16, (5, 3))
    tc = tns.CSRGraph(500, g["senders"], g["receivers"])
    jc = jns.CSRGraph(500, g["senders"], g["receivers"])
    np.testing.assert_array_equal(tc.indptr, jc.indptr)
    np.testing.assert_array_equal(tc.dst_sorted, jc.dst_sorted)
    ts = tns.minibatch_stream(seed, g, 16, (5, 3))
    js = jns.minibatch_stream(seed, g, 16, (5, 3))
    for _ in range(3):
        _equal(next(ts), next(js))
