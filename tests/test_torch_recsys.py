"""Port parity of the recsys slice: configs, CTR data and the FM model.

Weights are initialised once in JAX (``repro.models.recsys.init``) and
carried across with ``repro_torch.bridge``; ids come from numpy seeds.
The small config is ``tests/test_arch_smoke.py``'s.  Two sets of rows
are used: the init table, whose x0.01 scale makes the pairwise term
~1e-4 here, and unit-normal rows with non-zero linear rows and bias, so
that neither the interaction nor the linear term can vanish unnoticed.
Logits are compared at the reference's 2e-4 of their largest magnitude
(not of max(1, .)): a pairwise term of zero fails at both scales.
``forward(use_kernel=True)`` reaches kernel B4's wrapper, which runs its
plain version on the CPU; the JAX side runs its Pallas kernel in
interpret mode.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import fm as jfm
from repro.configs import registry as jreg
from repro.data import recsys_data as jdata
from repro.models import recsys as jrec
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.configs import fm as tfm
from repro_torch.configs import registry as treg
from repro_torch.data import recsys_data as tdata
from repro_torch.kernels.fm_interaction import kernel as fm_kernel
from repro_torch.kernels.fm_interaction import ops as fm_ops
from repro_torch.models import recsys as trec

SMALL = dict(name="fm-small", n_sparse=6, embed_dim=4,
             vocab_sizes=(50, 40, 30, 20, 10, 5))
JCFG, TCFG = jbase.RecsysConfig(**SMALL), tbase.RecsysConfig(**SMALL)


@functools.lru_cache(maxsize=None)
def _jax_params(unit: bool):
    """The JAX init as numpy; ``unit`` replaces the factor rows with
    unit-normal values and the linear rows and bias with non-zero ones."""
    jp = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda key: jrec.init(key, JCFG))(
            jax.random.PRNGKey(0)))
    if unit:
        rng = np.random.RandomState(11)
        rows = jp["tables"]["rows"].shape[0]
        jp = {"tables": {"rows": rng.normal(0, 1, (rows, 4))
                         .astype(np.float32)},
              "linear": {"rows": rng.normal(0, 0.1, (rows, 1))
                         .astype(np.float32)},
              "bias": np.asarray(0.3, np.float32)}
    return jp


def _both(unit: bool):
    jp = _jax_params(unit)
    return jax.tree_util.tree_map(jnp.asarray, jp), \
        bridge.params_from_jax(jp, device="cpu")


def _ids(batch, seed=0, cfg=JCFG):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(0, s, batch) for s in cfg.vocab_sizes],
                    1).astype(np.int32)


def _close(got, want, tol=2e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (float(np.abs(got - want).max()), scale)


# ---- configs ----------------------------------------------------------------

def test_fm_config_and_shapes_match_the_reference():
    assert tfm._criteo_like_sizes() == jfm._criteo_like_sizes()
    assert dataclasses.asdict(tfm.MODEL) == dataclasses.asdict(jfm.MODEL)
    assert tfm.MODEL.total_rows == jfm.MODEL.total_rows == 90_218_865
    assert list(tbase.RECSYS_SHAPES) == list(jbase.RECSYS_SHAPES)
    for name, shape in jbase.RECSYS_SHAPES.items():
        assert dataclasses.asdict(tbase.RECSYS_SHAPES[name]) \
            == dataclasses.asdict(shape)
    for f in ("arch_id", "family", "source", "skipped_shapes"):
        assert getattr(tfm.ARCH, f) == getattr(jfm.ARCH, f)
    assert tfm.ARCH.notes.startswith("90,218,865 total embedding rows")
    assert list(tfm.ARCH.runnable_shapes()) == list(
        jfm.ARCH.runnable_shapes())


def test_registry_resolves_the_ported_archs():
    assert treg.get_arch("fm") is tfm.ARCH
    assert set(treg.ARCH_MODULES) <= set(jreg.ARCH_MODULES)
    for arch_id in treg.ARCH_MODULES:
        assert dataclasses.asdict(treg.get_arch(arch_id).model) \
            == dataclasses.asdict(jreg.get_arch(arch_id).model)
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_arch("h2o-danube-1.8b")


@pytest.mark.parametrize("cfg", ["fm", "small"])
@pytest.mark.parametrize("multiple", [1024, 1, 512])
def test_field_offsets_and_padded_rows_match(cfg, multiple):
    jc, tc = (jfm.MODEL, tfm.MODEL) if cfg == "fm" else (JCFG, TCFG)
    a, b = jrec.field_offsets(jc), trec.field_offsets(tc)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    assert trec.padded_rows(tc, multiple) == jrec.padded_rows(jc, multiple)
    if cfg == "fm" and multiple == 1024:
        assert trec.padded_rows(tc) == 90_219_520


@pytest.mark.parametrize("seed,batch,sizes", [
    (0, 64, tfm.MODEL.vocab_sizes), (3, 17, SMALL["vocab_sizes"]),
    (9, 5, (7, 3))])
def test_ctr_batches_byte_identical(seed, batch, sizes):
    gj, gt = jdata.ctr_batches(seed, batch, sizes), \
        tdata.ctr_batches(seed, batch, sizes)
    for _ in range(3):
        a, b = next(gj), next(gt)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes()


# ---- params -------------------------------------------------------------------

def test_bridge_carries_the_fm_tree_with_its_0d_bias():
    jp = _jax_params(False)
    tp = bridge.params_from_jax(jp, device="cpu")
    assert set(tp) == {"tables", "linear", "bias"}
    assert tp["tables"]["rows"].shape == (trec.padded_rows(TCFG), 4)
    assert tp["linear"]["rows"].shape == (trec.padded_rows(TCFG), 1)
    assert tp["bias"].shape == () and tp["bias"].dtype == torch.float32
    back = bridge.params_to_numpy(tp)
    np.testing.assert_array_equal(back["tables"]["rows"],
                                  jp["tables"]["rows"])
    np.testing.assert_array_equal(back["bias"], jp["bias"])
    assert back["bias"].shape == ()


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_draws_on_the_device_with_the_reference_scale(param_dtype):
    cfg = tbase.RecsysConfig(name="fm-init", n_sparse=3, embed_dim=10,
                             vocab_sizes=(20000, 5000, 3),
                             param_dtype=param_dtype)
    p = trec.init(0, cfg, device="cpu")
    rows = trec.padded_rows(cfg)
    t = p["tables"]["rows"]
    assert t.device.type == "cpu" and t.shape == (rows, 10)
    assert t.dtype == getattr(torch, param_dtype)
    want = 0.01 / np.sqrt(10)
    tf = t.float()
    # 250k draws: the sample std is within 0.5% of the true one
    assert abs(float(tf.std()) - want) < 0.01 * want
    assert abs(float(tf.mean())) < 0.01 * want
    jt = np.asarray(jrec.init(jax.random.PRNGKey(0), JCFG)["tables"]["rows"])
    assert abs(float(jt.std()) - 0.01 / np.sqrt(4)) < 0.05 * 0.005
    assert p["linear"]["rows"].shape == (rows, 1)
    assert not p["linear"]["rows"].any() and p["bias"].shape == ()
    assert float(p["bias"]) == 0.0
    assert p["bias"].dtype == p["linear"]["rows"].dtype == t.dtype
    assert torch.equal(trec.init(0, cfg, device="cpu")["tables"]["rows"], t)
    assert not torch.equal(trec.init(1, cfg, device="cpu")["tables"]["rows"],
                           t)


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        trec.init(0, TCFG)


# ---- the model ------------------------------------------------------------------

@pytest.mark.parametrize("unit", [False, True], ids=["init", "unit"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_jax(unit, use_kernel):
    jp, tp = _both(unit)
    ids = _ids(16)
    want = jrec.forward(jp, JCFG, jnp.asarray(ids), use_kernel=use_kernel,
                        interpret=True)
    got = trec.forward(tp, TCFG, torch.from_numpy(ids),
                       use_kernel=use_kernel)
    assert got.dtype == torch.float32 and got.shape == (16,)
    _close(got.numpy(), want)


@pytest.mark.parametrize("unit", [False, True], ids=["init", "unit"])
def test_the_pairwise_term_is_held_at_its_own_scale(unit):
    """The interaction alone, port kernel path vs JAX kernel: under the
    init table it is ~1e-4, which an absolute 1e-4 would not see."""
    jp, tp = _both(unit)
    ids = _ids(32, seed=1)
    v, _ = jrec.lookup(jp, JCFG, jnp.asarray(ids))
    want = np.asarray(jrec.fm_interaction(v.astype(jnp.float32)))
    tv, _ = trec.lookup(tp, TCFG, torch.from_numpy(ids))
    _close(fm_ops.fm_interaction(tv).numpy(), want)
    if not unit:
        assert 1e-6 < float(np.abs(want).max()) < 1e-3


@pytest.mark.parametrize("unit", [False, True], ids=["init", "unit"])
def test_loss_fn_matches_jax(unit):
    jp, tp = _both(unit)
    batch = next(tdata.ctr_batches(5, 24, SMALL["vocab_sizes"]))
    jl, jm = jrec.loss_fn(jp, JCFG, {k: jnp.asarray(a)
                                     for k, a in batch.items()},
                          use_kernel=True, interpret=True)
    tl, tm = trec.loss_fn(tp, TCFG, {k: torch.from_numpy(a)
                                     for k, a in batch.items()},
                          use_kernel=True)
    _close(tl.numpy(), jl)
    assert float(tm["accuracy"]) == float(jm["accuracy"])


@pytest.mark.parametrize("unit", [False, True], ids=["init", "unit"])
def test_retrieval_score_matches_jax_and_the_forward_identity(unit):
    jp, tp = _both(unit)
    ids = _ids(1, seed=2)[0]
    cands = np.random.RandomState(3).randint(0, SMALL["vocab_sizes"][-1],
                                             9).astype(np.int32)
    want = jrec.retrieval_score(jp, JCFG, jnp.asarray(ids[:-1]),
                                jnp.asarray(cands))
    got = trec.retrieval_score(tp, TCFG, torch.from_numpy(ids[:-1]),
                               torch.from_numpy(cands))
    assert got.shape == (9,) and got.dtype == torch.float32
    _close(got.numpy(), want)
    # s(u, c) equals forward on [u || c], independent of the reference
    full = np.concatenate([np.repeat(ids[None, :-1], 9, 0), cands[:, None]],
                          1)
    fwd = trec.forward(tp, TCFG, torch.from_numpy(full), use_kernel=True)
    _close(got.numpy(), fwd.numpy())


def test_lookup_matches_jax_take_for_out_of_range_ids():
    """jnp.take's fill mode: -1 wraps to the last row (field 0) or lands
    in the previous field; an id past the table or below -rows gives NaN
    rows; an id past its own field's vocabulary lands in the next field."""
    jp, tp = _both(True)
    rows = trec.padded_rows(TCFG)
    ids = _ids(6, seed=4)
    ids[0, 0] = -1
    ids[1, 3] = -1
    ids[2, 2] = 35                       # past field 2's 30 ids
    ids[3, 5] = rows                     # past the table
    ids[4, 0] = -rows - 1                # below -rows
    ids[5, 4] = 10 ** 6
    jv, jw = jrec.lookup(jp, JCFG, jnp.asarray(ids))
    tv, tw = trec.lookup(tp, TCFG, torch.from_numpy(ids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert np.isnan(tv.numpy()[[3, 4, 5]]).any(-1).sum() == 3
    got = trec.forward(tp, TCFG, torch.from_numpy(ids), use_kernel=True)
    want = np.asarray(jrec.forward(jp, JCFG, jnp.asarray(ids),
                                   use_kernel=True, interpret=True))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    ok = ~np.isnan(want)
    _close(got.numpy()[ok], want[ok])


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax(mode, weighted):
    """Unsorted segment ids, an empty bag (3), a dropped segment id (-1,
    and one past n_segments) and a repeated row."""
    _, tp = _both(True)
    table = _jax_params(True)["tables"]["rows"]
    rng = np.random.RandomState(6)
    idx = np.array([5, 17, 3, 3, 40, 99, 150, 8, 2], np.int32)
    seg = np.array([2, 0, 4, 2, 0, 1, -1, 5, 4], np.int32)
    w = rng.normal(0, 1, idx.shape).astype(np.float32) if weighted else None
    want = jrec.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(seg), 5, mode=mode,
                              weights=None if w is None else jnp.asarray(w))
    got = trec.embedding_bag(tp["tables"]["rows"], torch.from_numpy(idx),
                             torch.from_numpy(seg), 5, mode=mode,
                             weights=None if w is None
                             else torch.from_numpy(w))
    assert got.shape == (5, 4)
    assert not got[3].any()                              # the empty bag
    _close(got.numpy(), want)


def test_embedding_bag_rejects_an_unknown_mode():
    with pytest.raises(ValueError):
        trec.embedding_bag(torch.zeros(4, 2), torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32), 1, mode="prod")


def test_forward_on_the_cpu_counts_no_kernel_launch():
    _, tp = _both(True)
    before = fm_kernel.fm_interaction_kernel_call.launches
    trec.forward(tp, TCFG, torch.from_numpy(_ids(4)), use_kernel=True)
    assert fm_kernel.fm_interaction_kernel_call.launches == before
