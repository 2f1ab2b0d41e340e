"""Port parity of the MoE LMs: ``repro_torch.models.transformer`` at
``tiny_config`` of moonshot-v1-16b-a3b (64 experts, top-6) and
arctic-480b (128 experts, top-2, a parallel dense residual FFN, bf16
params) against ``repro.models.transformer`` on the reference's weights
(carried across with ``bridge.params_from_jax``), on the CPU; per-layer
remat; the decode step's byte and FLOP count.

Bars, on results scaled to max(1, max |value|): fp32 2e-4, the
reference's ``PathSpec.tolerance`` for its XLA paths (the MoE's routing
is exact here: the router logits agree to ~1e-6 and no top-k margin is
that thin on these inputs); the init from a ``prng`` key within 4 ulps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import transformer as jtfm
from repro.serving import lm as jlm
from repro_torch import bridge
from repro_torch.common import prng
from repro_torch.common.tree import path_map, tree_leaves
from repro_torch.configs.registry import get_arch
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.serving.lm import tiny_config

TOL_FP32 = 2e-4
ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b"]


@functools.lru_cache(maxsize=None)
def _setup(arch_id, **extra):
    """(jax cfg, port cfg, jax params as numpy, port params on the CPU)."""
    jc = dataclasses.replace(jlm.tiny_config(jget_arch(arch_id).model),
                             **extra)
    tc = dataclasses.replace(tiny_config(get_arch(arch_id).model), **extra)
    jp = jax.tree_util.tree_map(np.asarray,
                                jtfm.init(jax.random.PRNGKey(0), jc))
    return jc, tc, jp, bridge.params_from_jax(jp, device="cpu")


_jforward = jax.jit(jtfm.forward, static_argnums=1)
_jloss = jax.jit(jtfm.loss_fn, static_argnums=1)
_jdecode = jax.jit(jtfm.decode_step, static_argnums=1)


def _toks(b, s, v=512, seed=0):
    return np.random.RandomState(seed).randint(0, v, (b, s)).astype(np.int32)


def _rel(a, b):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.detach().float().numpy()
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max()))


def test_moe_configs_match_the_reference():
    for arch_id in ARCHS:
        t, j = get_arch(arch_id), jget_arch(arch_id)
        assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
        for f in ("arch_id", "family", "source", "notes", "skipped_shapes"):
            assert getattr(t, f) == getattr(j, f)
        assert dataclasses.asdict(tiny_config(t.model)) \
            == dataclasses.asdict(jlm.tiny_config(j.model))
    m = get_arch("moonshot-v1-16b-a3b").model
    assert (m.n_layers, m.d_model, m.n_heads, m.n_kv_heads, m.d_ff,
            m.vocab_size, m.moe.n_experts, m.moe.top_k, m.param_dtype) \
        == (48, 2048, 16, 16, 1408, 163840, 64, 6, "float32")
    # 28.06 B params by count: 570.6 M a layer, 553.7 M of it experts
    layer = 4 * 2048 * 2048 + 2048 * 64 + 64 * 3 * 2048 * 1408
    total = 48 * (layer + 2 * 2048) + 2 * 163840 * 2048 + 2048
    assert round(layer / 1e5) == 5706 and round(total / 1e7) == 2806


@pytest.mark.parametrize("arch_id,n_experts", [("moonshot-v1-16b-a3b", 64),
                                               ("arctic-480b", 16)])
def test_init_from_a_prng_key_replays_the_reference(arch_id, n_experts):
    """Leaf by leaf within 4 ulps of ``jax.random``: moonshot's fp32
    params, and arctic's bf16 ones (cut to 16 experts: the replay draws
    in numpy)."""
    jc = jlm.tiny_config(jget_arch(arch_id).model)
    tc = tiny_config(get_arch(arch_id).model)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, n_experts=n_experts))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, n_experts=n_experts))
    jp = jtfm.init(jax.random.PRNGKey(0), jc)
    tp = ttfm.init(prng.key(0), tc, device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == tuple(b.shape)
        assert str(b.dtype)[6:] == tc.param_dtype == str(a.dtype)
        bits = np.int16 if tc.param_dtype == "bfloat16" else np.int32
        ulps = np.abs(np.asarray(a).view(bits).astype(np.int64)
                      - b.view(getattr(torch, str(np.dtype(bits))))
                      .numpy().astype(np.int64)).max()
        assert ulps <= 4


def test_init_from_a_seed_draws_the_moe_leaves_layer_by_layer():
    _, tc, jp, _ = _setup("moonshot-v1-16b-a3b")
    tp = ttfm.init(0, tc, device="cpu")
    assert [a.shape for a in jax.tree_util.tree_leaves(jp)] \
        == [tuple(b.shape) for b in tree_leaves(tp)]
    w = tp["layers"]["moe"]["experts"]["w_out"]
    assert not torch.equal(w[0], w[1])              # each layer its own
    std = (2.0 / tc.d_ff) ** 0.5
    assert abs(float(w.std()) - std) < 0.05 * std
    bf = dataclasses.replace(tc, param_dtype="bfloat16")
    assert all(t.dtype == torch.bfloat16
               for t in tree_leaves(ttfm.init(0, bf, device="cpu")))


def test_compute_params_casts_the_experts_once():
    _, tc, _, tp = _setup("moonshot-v1-16b-a3b")
    bf = dataclasses.replace(tc, compute_dtype="bfloat16")
    cp = ttfm.compute_params(tp, bf)
    dtypes = {}
    path_map(lambda p, t: dtypes.__setitem__(p, t.dtype), cp)
    assert dtypes["layers/moe/experts/w_gate"] == torch.bfloat16
    assert dtypes["layers/moe/experts/w_out"] == torch.bfloat16
    assert dtypes["layers/moe/router/w"] == torch.bfloat16
    assert dtypes["layers/ffn_norm/scale"] == torch.float32
    toks = torch.from_numpy(_toks(2, 8))
    assert torch.equal(ttfm.forward(tp, bf, toks)[0],
                       ttfm.forward(cp, bf, toks)[0])


@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_matches_the_reference(arch_id):
    jc, tc, jp, tp = _setup(arch_id)
    toks = _toks(2, 12)
    jl, jaux = _jforward(jp, jc, jnp.asarray(toks))
    tl, taux = ttfm.forward(tp, tc, torch.from_numpy(toks))
    assert tl.shape == (2, 12, ttfm.padded_vocab(tc))
    assert _rel(jl, tl) <= TOL_FP32
    assert float(jaux) > 0                     # the layers' aux losses
    assert abs(float(jaux) - float(taux)) <= TOL_FP32 * float(jaux)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_loss_with_aux_matches_the_reference(arch_id):
    jc, tc, jp, tp = _setup(arch_id)
    toks, labels = _toks(2, 16), _toks(2, 16, seed=1)
    labels[:, 12:] = -1
    jl, jm = _jloss(jp, jc, {"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(labels)})
    tl, tm = ttfm.loss_fn(tp, tc, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    for a, b in ((jl, tl), (jm["nll"], tm["nll"]), (jm["aux"], tm["aux"])):
        assert abs(float(a) - float(b)) <= TOL_FP32 * max(1.0, float(a))
    assert float(tl) == pytest.approx(float(tm["nll"]) + float(tm["aux"]))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_decode_step_matches_the_reference(arch_id):
    """10 greedy steps of three sequences (T = 3 tokens a step, so the
    capacity is 8 per expert) against the reference's ``decode_step``,
    logits per step and the caches after the last."""
    jc, tc, jp, tp = _setup(arch_id)
    toks = _toks(3, 10)
    jcache = jtfm.init_cache(jc, 3, 16)
    tcache = ttfm.init_cache(tc, 3, 16, device="cpu")
    err = 0.0
    for t in range(10):
        jl, jcache = _jdecode(jp, jc, jcache, jnp.asarray(toks[:, t]))
        tl, tcache = ttfm.decode_step(tp, tc, tcache,
                                      torch.from_numpy(toks[:, t]))
        err = max(err, _rel(jl, tl))
    assert err <= TOL_FP32
    for key in ("k", "v"):
        assert _rel(jcache[key], tcache[key]) <= TOL_FP32
    np.testing.assert_array_equal(np.asarray(jcache["pos"]),
                                  tcache["pos"].numpy())


def test_decode_matches_forward_without_drops():
    """The port alone, as phase 8b holds it on the card: with
    ``capacity_factor = E / k`` neither the decode steps (T = 2) nor the
    forward (T = 24) drops an assignment, so decode through the cache
    equals the teacher-forced forward."""
    _, tc, _, tp = _setup("moonshot-v1-16b-a3b")
    m = tc.moe
    cfg = dataclasses.replace(tc, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    assert tmoe.capacity(24, cfg.moe) >= 24 and tmoe.capacity(2, cfg.moe) >= 2
    toks = torch.from_numpy(_toks(2, 12))
    full, _ = ttfm.forward(tp, cfg, toks)
    cache = ttfm.init_cache(cfg, 2, 16, device="cpu")
    outs = []
    for t in range(12):
        lg, cache = ttfm.decode_step(tp, cfg, cache, toks[:, t])
        outs.append(lg)
    got = torch.stack(outs, 1)
    assert float((full - got).abs().max()) / max(
        1.0, float(full.abs().max())) <= TOL_FP32


@pytest.mark.parametrize("arch_id", [*ARCHS, "h2o-danube-1.8b"])
def test_remat_layer_gives_the_same_loss_and_grads(arch_id, monkeypatch):
    """``remat="layer"`` recomputes each layer in the backward: the loss
    and every grad equal those of ``remat="none"``, and each layer ran
    under ``torch.utils.checkpoint`` only when grads were asked for."""
    _, tc, _, tp = _setup(arch_id)
    toks, labels = _toks(2, 16), _toks(2, 16, seed=1)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    calls = []
    real = ttfm.checkpoint

    def counted(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)
    monkeypatch.setattr(ttfm, "checkpoint", counted)
    out = {}
    for remat in ("none", "layer"):
        cfg = dataclasses.replace(tc, remat=remat)
        leaves = [t.clone().float().requires_grad_(True)
                  for t in tree_leaves(tp)]
        from repro_torch.common.tree import tree_unflatten
        loss, _ = ttfm.loss_fn(tree_unflatten(tp, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss.detach(), grads)
    assert calls == [False] * tc.n_layers
    assert torch.equal(out["none"][0], out["layer"][0])
    for a, b in zip(out["none"][1], out["layer"][1]):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-9)
    with torch.no_grad():
        ttfm.loss_fn(tp, dataclasses.replace(tc, remat="layer"), batch)
    assert len(calls) == tc.n_layers            # no remat without grads


def test_arctic_dense_residual_layer_matches_the_reference():
    """One Arctic block alone: attention, then the experts' output plus
    the parallel dense FFN on the same normed input."""
    jc, tc, jp, tp = _setup("arctic-480b")
    assert tc.moe.dense_residual and "ffn" in tp["layers"]
    h = np.random.RandomState(4).normal(0, 1, (2, 6, tc.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    jlp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), jp["layers"])
    jh, _, jaux = jtfm._layer_fn(jlp, jc, jnp.asarray(h), jnp.asarray(pos))
    from repro_torch.nn.rope import rope_cos_sin
    q_pos = torch.from_numpy(pos)
    th, _, taux = ttfm._layer_fn(
        ttfm._layer(tp["layers"], 0), tc, torch.from_numpy(h), q_pos,
        rope_cos_sin(q_pos, tc.head_dim_, tc.rope_theta))
    assert _rel(jh, th) <= TOL_FP32
    assert abs(float(jaux) - float(taux)) <= TOL_FP32 * float(jaux)
    no_ffn = dict(tp["layers"], ffn={k: {"w": torch.zeros_like(v["w"])}
                                     for k, v in tp["layers"]["ffn"].items()})
    th0, _, _ = ttfm._layer_fn(
        ttfm._layer(no_ffn, 0), tc, torch.from_numpy(h), q_pos,
        rope_cos_sin(q_pos, tc.head_dim_, tc.rope_theta))
    assert float((th - th0).abs().max()) > 1e-3  # the dense branch adds


def test_h100_model_counts_an_moe_decode_step_by_hand():
    """moonshot-v1-16b-a3b at 16 slots over T = 2,048: every expert's
    three bf16 matrices (the dispatch runs all 64 whatever the routing),
    the router, attention, the LM head once, the embedding rows, fp32
    norms, the whole K / V cache read and this step's rows written,
    slot_pos and fp32 logits; FLOPs of the tokens' dense products and
    of the 64 x 8 capacity rows."""
    from repro_torch.core.codesign import H100Model
    cfg = get_arch("moonshot-v1-16b-a3b").model
    b, t = 16, 2048
    attn_w = 4 * 2048 * 2048
    router = 2048 * 64
    experts = 64 * 3 * 2048 * 1408
    head = 2048 * 163840
    weights = 2 * (48 * (attn_w + router + experts) + head + b * 2048) \
        + 4 * (2 * 48 + 1) * 2048
    kv_row = 48 * 2 * 16 * 128 * 2                   # 393,216 B a token
    assert kv_row == 393216
    nbytes = weights + b * kv_row * (t + 1) + 4 * b * t + 4 * b * 163840
    cap = 8
    flops = 48 * (b * (2 * (attn_w + router) + 4 * 16 * 128 * t)
                  + 2 * 64 * cap * 3 * 2048 * 1408) + b * 2 * 2048 * 163840
    got_flops, got_bytes = H100Model.lm_decode_step(cfg, b, t)
    assert got_bytes == nbytes and got_flops == flops
    assert 68e9 < got_bytes < 69e9                  # ~20.4 ms at 3.35 TB/s
    # arctic adds its dense residual FFN a layer, for every token
    a = get_arch("arctic-480b").model
    fa, ba = H100Model.lm_decode_step(a, 4, 64)
    fa0, ba0 = H100Model.lm_decode_step(
        a.__class__(**{**a.__dict__, "moe": dataclasses.replace(
            a.moe, dense_residual=False)}), 4, 64)
    ffn = 3 * 7168 * 4864
    assert ba - ba0 == 2 * 35 * ffn and fa - fa0 == 35 * 4 * 2 * ffn
