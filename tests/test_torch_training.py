"""Port parity of the training stack: schedules, optimizers, the train
step, gradient accumulation, gradient compression.

Each port function is held against ``repro.training`` on the same numpy
inputs (weights carried across with ``repro_torch.bridge``), with the
tolerance stated at each test:

* ``common/prng.py`` against ``jax.random``: keys and splits bitwise,
  normals within 3 ulps (XLA's erfinv polynomial evaluated with numpy's
  ``log1p``) and a JEDI-net init from a key within 4 (one more rounding
  in the scaling by the init's std);
* schedules: rtol 1e-6 (fp32 with the same constants; ``cos`` / ``pow``
  may differ by an ulp between XLA and torch);
* optimizers on identical grads, params and state, 3 updates: rtol 1e-5
  and atol 1e-7 on params and state (the same fp32 operations; one
  product may be fused into an FMA on one side, and Adafactor's means
  sum in another order); a bf16 leaf within one bf16 ulp (2^-8);
* the JEDI-net and FM train steps' loss at rtol 1e-5 and grads at 1e-4
  of each leaf's largest magnitude (the forward and backward sum in
  another order than XLA); 3 SGD steps end to end at 1e-4 (SGD carries
  a gradient difference linearly, where Adam's first step is ~lr x
  sign(g) and would flip an entry at the noise level);
* ``quantize`` / ``dequantize`` bitwise (the same IEEE division, round
  half to even and product); the world-size-1 ``ef_compressed_psum``
  within 1e-6 of each leaf's largest magnitude (XLA may contract
  ``corrected - q * scale`` into one FMA, which moves the residual by an
  ulp of the product).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jbase
from repro.core import interaction_net as jinet
from repro.models import recsys as jrec
from repro.training import grad_compression as jgc
from repro.training import make_optimizer as j_make_optimizer
from repro.training import make_train_step as j_make_train_step
from repro.training import optimizer as jopt
from repro.training import schedule as jsched
from repro_torch import bridge
from repro_torch.common import prng
from repro_torch.common import tree as ttree
from repro_torch.configs import base as tbase
from repro_torch.core import interaction_net as tinet
from repro_torch.data.jets import make_jets
from repro_torch.models import recsys as trec
from repro_torch.training import grad_compression as tgc
from repro_torch.training import init_state, make_optimizer, make_train_step
from repro_torch.training import optimizer as topt
from repro_torch.training import schedule as tsched

STEPS = [0, 1, 49, 50, 51, 2500, 4999, 5000, 9000]
SCHEDS = {
    "constant": ((3e-4,), {}),
    "warmup_cosine": ((2e-3, 50, 5000), {}),
    "wsd": ((1e-3, 50, 5000), {}),
    "wsd_long_decay": ((1e-3, 50, 5000), {"decay_frac": 0.5,
                                          "final_frac": 0.05}),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cpu(tree):
    return bridge.params_from_jax(tree, device="cpu")


def _close(got, want, rtol, atol, what=""):
    for (path, g), w in zip(
            jax.tree_util.tree_leaves_with_path(bridge.params_to_numpy(got)),
            jax.tree_util.tree_leaves(_np(want))):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {path}")


# --- schedules ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCHEDS))
def test_schedule_matches_reference(name):
    args, kw = SCHEDS[name]
    kind = name.split("_long")[0]
    jf = jsched.SCHEDULES[kind](*args, **kw)
    tf = tsched.SCHEDULES[kind](*args, **kw)
    for s in STEPS:
        want = np.float32(jf(jnp.asarray(s, jnp.int32)))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = tf(step)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=0, err_msg=f"{name} step {s}")


def test_schedule_stays_on_the_steps_device():
    step = torch.zeros((), dtype=torch.int32, device="meta")
    for kind, (args, kw) in SCHEDS.items():
        f = tsched.SCHEDULES[kind.split("_long")[0]](*args, **kw)
        assert f(step).device.type == "meta"


# --- the reference's random draws --------------------------------------------

def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("seed", [0, 1, 12345, -1, 2**33 + 7])
def test_prng_replays_jax_random(seed):
    """Keys and splits bitwise; normals within 3 ulps (XLA's erfinv
    polynomial, numpy's log1p), most of them equal."""
    k = prng.key(seed)
    np.testing.assert_array_equal(k, np.asarray(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(
        np.stack(prng.split(k, 5)),
        np.asarray(jax.random.split(jax.random.PRNGKey(seed), 5)))
    for shape in [(1,), (7,), (3, 5, 2), (256, 128)]:
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = prng.normal(k, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert _ulps(got.numpy(), want) <= 3
        assert (got.numpy() == want).mean() >= 0.9


def test_erfinv_f32_follows_xla():
    u = np.random.RandomState(0).uniform(-1, 1, 100000).astype(np.float32)
    u = np.concatenate([u, np.float32(1) - np.logspace(-7, -1, 50,
                                                      dtype=np.float32)])
    assert _ulps(prng.erfinv_f32(u),
                 np.asarray(jax.lax.erf_inv(jnp.asarray(u)))) <= 2


@pytest.mark.parametrize("scale", ["fan_in", "lecun"])
def test_jedinet_init_from_a_key_is_the_references_init(scale):
    cfg = jinet.JediNetConfig(n_objects=50, fr_hidden=(50, 50))
    tcfg = tinet.JediNetConfig(n_objects=50, fr_hidden=(50, 50))
    for seed in (0, 3):
        want = jinet.init(jax.random.PRNGKey(seed), cfg, scale=scale)
        got = tinet.init(prng.key(seed), tcfg, scale=scale, device="cpu")
        for a, b in zip(ttree.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert tuple(a.shape) == np.asarray(b).shape
            assert _ulps(a.numpy(), b) <= 4     # 3 of the draw, 1 of std


# --- tree, clip --------------------------------------------------------------

def _tree(rng):
    return {"a": rng.normal(0, 3, (7, 5)).astype(np.float32),
            "b": [rng.normal(0, 1, (4,)).astype(np.float32),
                  {"c": rng.normal(0, 0.1, (2, 3, 2)).astype(np.float32)}],
            "s": np.asarray(2.5, np.float32)}


def test_global_norm_and_tree_helpers_match_reference():
    from repro.common import tree as jtree
    tree = _tree(np.random.RandomState(0))
    jt, tt = jax.tree_util.tree_map(jnp.asarray, tree), _cpu(tree)
    gn = ttree.global_norm(tt)
    assert gn.dtype == torch.float32 and gn.dim() == 0
    np.testing.assert_allclose(gn.numpy(), np.asarray(jtree.global_norm(jt)),
                               rtol=1e-6)
    assert ttree.param_count(tt) == jtree.param_count(jt)
    assert ttree.param_bytes(tt) == jtree.param_bytes(jt)
    assert ttree.param_bytes(ttree.tree_cast(tt, torch.bfloat16)) == \
        jtree.param_bytes(jtree.tree_cast(jt, jnp.bfloat16))
    jpaths, tpaths = [], []
    jtree.path_map(lambda p, l: jpaths.append(p) or l, jt)
    ttree.path_map(lambda p, l: tpaths.append(p) or l, tt)
    assert tpaths == jpaths
    assert [x.shape for x in ttree.tree_leaves(tt)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jt)]
    _close(ttree.tree_add(tt, ttree.tree_scale(tt, 0.5)),
           jtree.tree_add(jt, jtree.tree_scale(jt, 0.5)), 1e-7, 0)
    _close(ttree.tree_zeros_like(tt), jtree.tree_zeros_like(jt), 0, 0)


@pytest.mark.parametrize("clip", [1.0, 100.0, None])
def test_clip_tree_matches_reference(clip):
    tree = _tree(np.random.RandomState(1))
    jg, jn = jopt._clip_tree(jax.tree_util.tree_map(jnp.asarray, tree), clip)
    tg, tn = topt._clip_tree(_cpu(tree), clip)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    _close(tg, jg, 1e-6, 0, "clipped")


# --- optimizers on identical grads -------------------------------------------

def _opt_params(rng):
    return {"w": rng.normal(0, 0.1, (256, 128)).astype(np.float32),
            "m": rng.normal(0, 0.1, (16, 8)).astype(np.float32),
            "b": rng.normal(0, 0.1, (128,)).astype(np.float32)}


OPT_CASES = {
    "sgd": ("sgd", {"weight_decay": 0.01}),
    "adamw": ("adamw", {}),
    "adamw_noclip_nodecay": ("adamw", {"clip_norm": None,
                                       "weight_decay": 0.0}),
    "adafactor": ("adafactor", {"weight_decay": 0.01}),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_reference_on_identical_grads(case):
    name, kw = OPT_CASES[case]
    rng = np.random.RandomState(2)
    params = _opt_params(rng)
    jo = j_make_optimizer(name, jsched.warmup_cosine(1e-2, 2, 10), **kw)
    to = make_optimizer(name, tsched.warmup_cosine(1e-2, 2, 10), **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jo.init(jp)
    tp = _cpu(params)
    ts = to.init(tp)
    _close(ts, js, 0, 0, "init")
    if name == "adafactor":             # factored 256x128, full v elsewhere
        assert set(ts["acc"]["w"]) == {"r", "c"}
        assert set(ts["acc"]["m"]) == {"v"} and set(ts["acc"]["b"]) == {"v"}
    for i in range(3):
        # steps 1-3: lr > 0 at each (warmup, then cosine)
        step = i + 1
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)
        jp, js, jm = jo.update(jax.tree_util.tree_map(jnp.asarray, grads),
                               js, jp, jnp.asarray(step, jnp.int32))
        tp, ts, tm = to.update(_cpu(grads), ts, tp,
                               torch.tensor(step, dtype=torch.int32))
        _close(tp, jp, 1e-5, 1e-7, f"params after update {i}")
        _close(ts, js, 1e-5, 1e-7, f"state after update {i}")
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-6)


def test_adamw_writes_a_bf16_param_back_in_bf16():
    rng = np.random.RandomState(3)
    p32 = rng.normal(0, 1, (64, 32)).astype(np.float32)
    jo = j_make_optimizer("adamw", jsched.constant(1e-2))
    to = make_optimizer("adamw", tsched.constant(1e-2))
    jp = {"w": jnp.asarray(p32, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p32).to(torch.bfloat16)}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = rng.normal(0, 1, p32.shape).astype(np.float32)
        jp, js, _ = jo.update({"w": jnp.asarray(g)}, js, jp,
                              jnp.asarray(step, jnp.int32))
        tp, ts, _ = to.update({"w": torch.from_numpy(g)}, ts, tp,
                              torch.tensor(step, dtype=torch.int32))
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(tp["w"].float().numpy(),
                               np.asarray(jp["w"], np.float32),
                               rtol=2 ** -8, atol=0)


def test_adafactor_memory_is_sublinear():
    opt = make_optimizer("adafactor", tsched.constant(1e-3))
    st = opt.init({"w": torch.zeros((512, 512))})
    assert ttree.param_count(st) == 1024       # r (512) + c (512)


@pytest.mark.parametrize("name,lr", [("sgd", 0.02), ("adamw", 0.1),
                                     ("adafactor", 0.1)])
def test_optimizer_reduces_quadratic(name, lr):
    opt = make_optimizer(name, tsched.constant(lr))
    target = torch.from_numpy(
        np.random.RandomState(0).normal(0, 1, (16, 16)).astype(np.float32))
    state = init_state(0, lambda _: {"w": torch.zeros((16, 16))}, opt)
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0

    def loss(p, _):
        # sum (not mean) keeps gradient scale O(1) for momentum SGD
        return torch.sum(torch.square(p["w"] - target)), {}

    step = make_train_step(loss, opt)
    l0 = None
    for _ in range(150):
        state, m = step(state, {})
        l0 = l0 if l0 is not None else float(m["loss"])
    assert int(state["step"]) == 150
    assert float(m["loss"]) < 0.1 * l0


# --- the train step ----------------------------------------------------------

def _capture():
    """An optimizer that records the grads it is handed and changes
    nothing."""
    seen = {}

    def update(grads, state, params, step):
        seen["grads"] = grads
        return params, state, {}

    return topt.Optimizer(lambda p: {}, update, "capture"), seen


def _jax_jedi(cfg, scale):
    return _np(jax.jit(lambda k: jinet.init(k, cfg, scale=scale))(
        jax.random.PRNGKey(0)))


def _leafwise_close(got, want, tol, what):
    for (path, g), w in zip(
            jax.tree_util.tree_leaves_with_path(bridge.params_to_numpy(got)),
            jax.tree_util.tree_leaves(_np(want))):
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{what} {path}: {err:.3e} vs {scale:.3e}"


@pytest.mark.parametrize("scale", ["fan_in", "lecun"])
def test_jedinet_train_step_loss_and_grads_match_value_and_grad(scale):
    cfg = jinet.JediNetConfig()
    jp = _jax_jedi(cfg, scale)
    x, y = make_jets(np.random.RandomState(4), 64, cfg.n_objects)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jinet.loss_fn(p, cfg, b), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tcfg = tinet.JediNetConfig()
    opt, seen = _capture()
    step = make_train_step(lambda p, b: tinet.loss_fn(p, tcfg, b), opt)
    state = {"params": _cpu(jp), "opt": {},
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = step(state, {"x": torch.from_numpy(x),
                            "y": torch.from_numpy(y)})
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(m["accuracy"].numpy(),
                               np.asarray(jm["accuracy"]), rtol=0)
    assert all(g.dtype == torch.float32
               for g in ttree.tree_leaves(seen["grads"]))
    _leafwise_close(seen["grads"], jg, 1e-4, "grad")


def test_jedinet_sgd_steps_match_reference_end_to_end():
    cfg = jinet.JediNetConfig()
    tcfg = tinet.JediNetConfig()
    jp = _jax_jedi(cfg, "lecun")
    jo = j_make_optimizer("sgd", jsched.constant(1e-2))
    to = make_optimizer("sgd", tsched.constant(1e-2))
    js = {"params": jax.tree_util.tree_map(jnp.asarray, jp),
          "opt": jo.init(jp), "step": jnp.zeros((), jnp.int32)}
    ts = bridge.state_from_jax(_np(js), device="cpu")
    jstep = jax.jit(j_make_train_step(
        lambda p, b: jinet.loss_fn(p, cfg, b), jo))
    tstep = make_train_step(lambda p, b: tinet.loss_fn(p, tcfg, b), to)
    rng = np.random.RandomState(5)
    for _ in range(3):
        x, y = make_jets(rng, 32, cfg.n_objects)
        js, jm = jstep(js, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        ts, tm = tstep(ts, {"x": torch.from_numpy(x),
                            "y": torch.from_numpy(y)})
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=1e-4)
    assert int(ts["step"]) == int(js["step"]) == 3
    _leafwise_close(ts["params"], js["params"], 1e-4, "params")
    _leafwise_close(ts["opt"], js["opt"], 1e-4, "momentum")


def test_grad_accum_equivalence():
    """The reference's case (``tests/test_data_training.py``): AdamW,
    grad_accum=4 over 16 rows equals one step over all 16, and equals the
    reference's own grad-accum step."""
    target = np.random.RandomState(0).normal(0, 1, (8,)).astype(np.float32)
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (16, 8)))
    opt = make_optimizer("adamw", tsched.constant(1e-2))
    tt = torch.from_numpy(target)

    def loss(p, b):
        pred = b["x"] @ p["w"]
        return torch.mean(torch.square(pred - b["x"] @ tt)), \
            {"pred_mean": pred.mean()}

    def fresh():
        return init_state(0, lambda _: {"w": torch.zeros((8,))}, opt)

    s1, m1 = make_train_step(loss, opt)(fresh(), {"x": torch.from_numpy(x)})
    s4, m4 = make_train_step(loss, opt, grad_accum=4)(
        fresh(), {"x": torch.from_numpy(x)})
    np.testing.assert_allclose(s1["params"]["w"].numpy(),
                               s4["params"]["w"].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(m4["loss"].numpy(), m1["loss"].numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(m4["pred_mean"].numpy(), 0.0, atol=1e-7)

    jo = j_make_optimizer("adamw", jsched.constant(1e-2))
    jt = jnp.asarray(target)

    def jloss(p, b):
        pred = b["x"] @ p["w"]
        return jnp.mean(jnp.square(pred - b["x"] @ jt)), \
            {"pred_mean": pred.mean()}

    jp = {"w": jnp.zeros((8,))}
    js = {"params": jp, "opt": jo.init(jp), "step": jnp.zeros((), jnp.int32)}
    js, jm = jax.jit(j_make_train_step(jloss, jo, grad_accum=4))(
        js, {"x": jnp.asarray(x)})
    np.testing.assert_allclose(s4["params"]["w"].numpy(),
                               np.asarray(js["params"]["w"]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(m4["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)


# --- FM at a narrow config ---------------------------------------------------

SMALL = dict(name="fm-small", n_sparse=6, embed_dim=4,
             vocab_sizes=(50, 40, 30, 20, 10, 5))


@functools.lru_cache(maxsize=None)
def _fm_setup():
    jcfg = jbase.RecsysConfig(**SMALL)
    jp = _np(jax.jit(lambda k: jrec.init(k, jcfg))(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(6)
    rows = jp["tables"]["rows"].shape[0]
    # rows large enough that the pairwise term moves the loss
    jp = {"tables": {"rows": rng.normal(0, 0.5, (rows, 4)).astype(np.float32)},
          "linear": {"rows": rng.normal(0, 0.1, (rows, 1)).astype(np.float32)},
          "bias": np.asarray(0.1, np.float32)}
    from repro.data.recsys_data import ctr_batches
    it = ctr_batches(0, 128, jcfg.vocab_sizes)
    return jcfg, jp, [next(it) for _ in range(3)]


def test_fm_train_step_loss_and_grads_match_value_and_grad():
    jcfg, jp, batches = _fm_setup()
    tcfg = tbase.RecsysConfig(**SMALL)
    b = batches[0]
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, bb: jrec.loss_fn(p, jcfg, bb), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in b.items()})
    opt, seen = _capture()
    step = make_train_step(lambda p, bb: trec.loss_fn(p, tcfg, bb), opt)
    _, m = step({"params": _cpu(jp), "opt": {},
                 "step": torch.zeros((), dtype=torch.int32)},
                {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(m["accuracy"].numpy(),
                               np.asarray(jm["accuracy"]), rtol=0)
    _leafwise_close(seen["grads"], jg, 1e-4, "grad")


def test_fm_sgd_steps_match_reference_end_to_end():
    jcfg, jp, batches = _fm_setup()
    tcfg = tbase.RecsysConfig(**SMALL)
    jo = j_make_optimizer("sgd", jsched.constant(0.05), weight_decay=0.0)
    to = make_optimizer("sgd", tsched.constant(0.05), weight_decay=0.0)
    js = {"params": jax.tree_util.tree_map(jnp.asarray, jp),
          "opt": jo.init(jp), "step": jnp.zeros((), jnp.int32)}
    ts = bridge.state_from_jax(_np(js), device="cpu")
    jstep = jax.jit(j_make_train_step(
        lambda p, b: jrec.loss_fn(p, jcfg, b), jo))
    tstep = make_train_step(lambda p, b: trec.loss_fn(p, tcfg, b), to)
    for b in batches:
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=1e-5)
    _leafwise_close(ts["params"], js["params"], 1e-4, "params")


# --- gradient compression ----------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_matches_reference_including_ties(bits):
    qmax = 2 ** (bits - 1) - 1
    # amax = qmax makes scale exactly 1, so x / scale lands on the .5 ties
    ties = np.asarray([qmax, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                       -126.5, 0.0], np.float32)
    rand = np.random.RandomState(7).normal(0, 2, (1000,)).astype(np.float32)
    for x in (ties, rand):
        jq, js = jgc.quantize(jnp.asarray(x), bits=bits)
        tq, ts = tgc.quantize(torch.from_numpy(x), bits=bits)
        assert tq.dtype == (torch.int8 if bits == 8 else torch.int16)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tgc.dequantize(tq, ts).numpy(),
                                      np.asarray(jgc.dequantize(jq, js)))
    tq, _ = tgc.quantize(torch.from_numpy(ties), bits=bits)
    assert tq[1:4].tolist() == [0, 2, 2]           # half to even
    with pytest.raises(ValueError):
        tgc.quantize(torch.zeros(3), bits=4)


def test_ef_compressed_psum_on_a_world_size_1_gloo_group(tmp_path):
    """One process, one rank: the all-reduces return their input, so the
    mean is the dequantized value and the residual carries the rest —
    held against the reference with its axis bound by ``vmap`` over one
    device, over 3 error-feedback steps, at 1e-6 of each leaf's largest
    magnitude."""
    rng = np.random.RandomState(8)
    grads = [{"w": rng.normal(0, 1, (33, 7)).astype(np.float32),
              "b": [rng.normal(0, 1e-3, (5,)).astype(np.float32)]}
             for _ in range(3)]
    jfn = jax.jit(jax.vmap(lambda g, r: jgc.ef_compressed_psum(g, r, "d"),
                           axis_name="d"))
    jr = jax.tree_util.tree_map(lambda a: np.zeros((1,) + a.shape,
                                                   np.float32), grads[0])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        group = dist.new_group([0])
        tr = jax.tree_util.tree_map(lambda a: torch.zeros(a.shape),
                                    grads[0])
        for g in grads:
            jm, jr = jfn(jax.tree_util.tree_map(lambda a: a[None], g), jr)
            tm, tr = tgc.ef_compressed_psum(_cpu(g), tr, group)
            for got, want in ((tm, jm), (tr, jr)):
                for a, w, gl in zip(ttree.tree_leaves(got),
                                    jax.tree_util.tree_leaves(want),
                                    jax.tree_util.tree_leaves(g)):
                    np.testing.assert_allclose(
                        a.numpy(), np.asarray(w)[0], rtol=0,
                        atol=1e-6 * float(np.abs(gl).max()))
    finally:
        dist.destroy_process_group()
