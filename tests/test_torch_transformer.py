"""Port parity of the dense LM: configs, RoPE, attention, the transformer.

The same numpy inputs and the same weights (made by the JAX reference
and carried across with ``bridge.params_from_jax``) go through
``repro.models.transformer`` and ``repro_torch.models.transformer`` on
the CPU.  The decode step's attention runs kernel B5's plain version
here (the wrapper takes it for CPU tensors); the kernel itself is held
against that plain version in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Bars, on results scaled to max(1, max |value|):

* fp32: 2e-4, the reference's ``PathSpec.tolerance`` for its XLA paths
  (the two frameworks sum in other orders; the gap is ~1e-6);
* bf16: 5e-2, the reference's bf16 bar for B5 (``tests/test_kernels.py``):
  a product, a sum or an activation that lands on the other side of a
  bf16 rounding boundary moves that value by 2^-8 of it, and the flips
  add up over the layers;
* the init from a ``prng`` key: within 4 ulps of ``jax.random`` leaf by
  leaf (3 ulps of the normal draw, one rounding of the scaling).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import transformer as jtfm
from repro.nn import attention as jatt
from repro.nn import rope as jrope
from repro_torch import bridge
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttfm
from repro_torch.nn import attention as tatt
from repro_torch.nn import rope as trope

TOL_FP32 = 2e-4
TOL_BF16 = 5e-2

BASE = dict(name="t-test", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab_size=100, remat="none", compute_dtype="float32")
VARIANTS = {"dense": {}, "swa": dict(sliding_window=8),
            "tied": dict(tie_embeddings=True),
            "bf16": dict(compute_dtype="bfloat16")}


def _cfgs(variant, **extra):
    kw = {**BASE, **VARIANTS[variant], **extra}
    return jbase.TransformerConfig(**kw), tbase.TransformerConfig(**kw)


def _tol(cfg):
    return TOL_BF16 if cfg.compute_dtype == "bfloat16" else TOL_FP32


@functools.lru_cache(maxsize=None)
def _params(variant, **extra):
    """(jax cfg, port cfg, jax params, port params on the CPU)."""
    jc, tc = _cfgs(variant, **extra)
    jp = jax.tree_util.tree_map(np.asarray,
                                jtfm.init(jax.random.PRNGKey(0), jc))
    return jc, tc, jp, bridge.params_from_jax(jp, device="cpu")


#: the reference's decode step, compiled once per config (an eager step
#: re-traces its layer scan on every call)
_jdecode = jax.jit(jtfm.decode_step, static_argnums=1)


def _toks(b, s, v=100, seed=0):
    return np.random.RandomState(seed).randint(0, v, (b, s)).astype(np.int32)


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b,
                   np.float32)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max()))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --- configs -----------------------------------------------------------------

def test_lm_configs_and_shapes_match_the_reference():
    assert list(tbase.LM_SHAPES) == list(jbase.LM_SHAPES)
    for name, shape in jbase.LM_SHAPES.items():
        assert dataclasses.asdict(tbase.LM_SHAPES[name]) \
            == dataclasses.asdict(shape)
    moe = dict(n_experts=4, top_k=2)
    assert dataclasses.asdict(tbase.MoEConfig(**moe)) \
        == dataclasses.asdict(jbase.MoEConfig(**moe))
    for arch_id in ("h2o-danube-1.8b", "minicpm-2b", "phi3-medium-14b"):
        t, j = treg.get_arch(arch_id), jreg.get_arch(arch_id)
        assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
        for f in ("arch_id", "family", "source", "notes", "skipped_shapes"):
            assert getattr(t, f) == getattr(j, f)
        assert t.model.head_dim_ == j.model.head_dim_
        assert t.model.is_full_attention == j.model.is_full_attention
        assert ttfm.padded_vocab(t.model) == jtfm.padded_vocab(j.model)
    assert ttfm.padded_vocab(treg.get_arch("minicpm-2b").model) == 122880
    assert treg.get_arch("h2o-danube-1.8b").model.head_dim_ == 80


# --- RoPE and attention --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_the_reference(dtype):
    rng = np.random.RandomState(0)
    pos = rng.randint(0, 5000, (2, 7)).astype(np.int32)
    x = rng.normal(0, 1, (2, 7, 3, 80)).astype(np.float32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 80, 10000.0)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), 80, 10000.0)
    assert _rel(jc, tc) < 1e-6 and _rel(js, ts) < 1e-6
    jx = jrope.apply_rope(jnp.asarray(x).astype(dtype), jc, js)
    tx = trope.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                          tc, ts)
    assert tx.dtype == getattr(torch, dtype)
    # fp32 math on the same inputs; bf16 rounds once at the end
    assert _rel(_np(jx), tx) <= (2 ** -8 if dtype == "bfloat16" else 1e-6)


ATTN_CASES = {
    "full": dict(),
    "blockwise kv_chunk=8": dict(kv_chunk=8),
    "blockwise ragged kv_chunk=7": dict(kv_chunk=7),
    "q_chunk=8": dict(kv_chunk=8, q_chunk=8),
    "window=5": dict(window=5),
    "window=5 blockwise": dict(window=5, kv_chunk=8),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_the_reference(case, dtype):
    """Prefill-shaped self-attention (B=2, S=24, H=4, Hkv=2), causal, with
    the first three cache slots empty (-1) in row 1."""
    kw = ATTN_CASES[case]
    rng = np.random.RandomState(1)
    q = rng.normal(0, 1, (2, 24, 4, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, 24, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, 24, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    kv_pos = pos.copy()
    kv_pos[1, :3] = -1
    j = jatt.attention(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                       q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(kv_pos),
                       **kw)
    t = tatt.attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                         for a in (q, k, v)),
                       q_pos=torch.from_numpy(pos),
                       kv_pos=torch.from_numpy(kv_pos), **kw)
    assert t.dtype == getattr(torch, dtype) and t.shape == (2, 24, 4, 16)
    tol = TOL_FP32 if dtype == "float32" else TOL_BF16
    assert _rel(_np(j), t) <= tol


def test_attention_row_with_no_valid_key_is_zero():
    """The finite NEG_INF and the clamp of the running max at NEG_INF / 2:
    a query with no valid key gets every weight exp(-5e29) = 0 and an
    output of 0, as the reference's.  (B5 gives the mean of v there; the
    decode step never asks, since it writes the query's own slot first.)"""
    rng = np.random.RandomState(2)
    q = rng.normal(0, 1, (1, 1, 2, 8)).astype(np.float32)
    k = rng.normal(0, 1, (1, 5, 2, 8)).astype(np.float32)
    v = rng.normal(0, 1, (1, 5, 2, 8)).astype(np.float32)
    kv_pos = np.full((1, 5), -1, np.int32)
    args = dict(q_pos=np.zeros((1, 1), np.int32), kv_pos=kv_pos)
    j = jatt.attention(*map(jnp.asarray, (q, k, v)),
                       **{n: jnp.asarray(a) for n, a in args.items()})
    t = tatt.attention(*map(torch.from_numpy, (q, k, v)),
                       **{n: torch.from_numpy(a) for n, a in args.items()})
    assert not t.any()
    assert _rel(_np(j), t) <= TOL_FP32


# --- the transformer -------------------------------------------------------------

def test_init_from_a_prng_key_replays_the_reference():
    for variant in ("dense", "tied"):
        jc, tc = _cfgs(variant)
        jp = jtfm.init(jax.random.PRNGKey(0), jc)
        tp = ttfm.init(prng.key(0), tc, device="cpu")
        jl = jax.tree_util.tree_leaves(jp)
        tl = tree_leaves(tp)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            a = np.asarray(a)
            assert a.shape == tuple(b.shape) and b.dtype == torch.float32
            ulps = np.abs(a.view(np.int32).astype(np.int64)
                          - b.numpy().view(np.int32).astype(np.int64)).max()
            assert ulps <= 4


def test_init_from_a_seed_draws_the_reference_shapes_and_scales():
    jc, tc = _cfgs("dense")
    jp = jtfm.init(jax.random.PRNGKey(0), jc)
    tp = ttfm.init(0, tc, device="cpu")
    assert [tuple(np.shape(a)) for a in jax.tree_util.tree_leaves(jp)] \
        == [tuple(b.shape) for b in tree_leaves(tp)]
    assert torch.equal(tp["embed"]["w"], ttfm.init(0, tc, device="cpu")
                       ["embed"]["w"])
    std = float(tp["layers"]["ffn"]["w_out"]["w"].std())
    assert abs(std - (2.0 / tc.d_ff) ** 0.5) < 0.1 * (2.0 / tc.d_ff) ** 0.5


def test_compute_params_casts_the_weight_matrices_once():
    jc, tc, _, tp = _params("bf16")
    cp = ttfm.compute_params(tp, tc)
    assert cp["embed"]["w"].dtype == torch.bfloat16
    assert cp["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert cp["layers"]["attn_norm"]["scale"].dtype == torch.float32
    assert cp["final_norm"]["scale"].dtype == torch.float32
    toks = torch.from_numpy(_toks(2, 12))
    a, _ = ttfm.forward(tp, tc, toks)
    b, _ = ttfm.forward(cp, tc, toks)
    assert torch.equal(a, b)                 # the same casts, made once


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_the_reference(variant):
    jc, tc, jp, tp = _params(variant)
    toks = _toks(2, 12)
    jl, _ = jtfm.forward(jp, jc, jnp.asarray(toks))
    tl, aux = ttfm.forward(tp, tc, torch.from_numpy(toks))
    assert tl.dtype == getattr(torch, tc.compute_dtype)
    assert tl.shape == (2, 12, ttfm.padded_vocab(tc)) and float(aux) == 0.0
    assert _rel(_np(jl), tl) <= _tol(tc)


@pytest.mark.parametrize("kv_chunk,q_chunk", [(8, None), (8, 8)])
def test_blockwise_forward_matches_the_reference(kv_chunk, q_chunk):
    jc, tc, jp, tp = _params("dense")
    toks = _toks(2, 32)
    jl, _ = jtfm.forward(jp, jc, jnp.asarray(toks), kv_chunk=kv_chunk,
                         q_chunk=q_chunk)
    tl, _ = ttfm.forward(tp, tc, torch.from_numpy(toks), kv_chunk=kv_chunk,
                         q_chunk=q_chunk)
    full, _ = ttfm.forward(tp, tc, torch.from_numpy(toks))
    assert _rel(_np(jl), tl) <= TOL_FP32
    assert _rel(full.numpy(), tl) <= TOL_FP32


@pytest.mark.parametrize("variant", ["dense", "tied"])
@pytest.mark.parametrize("logit_chunk", [None, 4])
def test_loss_matches_the_reference(variant, logit_chunk):
    jc, tc, jp, tp = _params(variant)
    toks, labels = _toks(2, 16), _toks(2, 16, seed=1)
    labels[:, 12:] = -1                      # ignored positions
    jl, jm = jtfm.loss_fn(jp, jc, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)},
                          logit_chunk=logit_chunk)
    tl, tm = ttfm.loss_fn(tp, tc, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)},
                          logit_chunk=logit_chunk)
    assert abs(float(jl) - float(tl)) <= TOL_FP32 * max(1.0, abs(float(jl)))
    assert abs(float(jm["nll"]) - float(tm["nll"])) <= TOL_FP32 * max(
        1.0, abs(float(jm["nll"])))
    full, _ = ttfm.loss_fn(tp, tc, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(labels)})
    assert abs(float(full) - float(tl)) < 1e-5


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_matches_the_reference(variant):
    """12 greedy steps of two sequences through each decode step, the
    port's attention through B5's plain version: logits per step against
    the reference's ``decode_step``, and the caches after the last step."""
    jc, tc, jp, tp = _params(variant)
    toks = _toks(2, 12)
    jcache = jtfm.init_cache(jc, 2, 16)
    tcache = ttfm.init_cache(tc, 2, 16, device="cpu")
    err = 0.0
    for t in range(12):
        jl, jcache = _jdecode(jp, jc, jcache, jnp.asarray(toks[:, t]))
        tl, tcache = ttfm.decode_step(tp, tc, tcache,
                                      torch.from_numpy(toks[:, t]))
        assert tl.dtype == torch.float32 and tl.shape == (2, ttfm.padded_vocab(tc))
        err = max(err, _rel(np.asarray(jl), tl))
    assert err <= _tol(tc)
    np.testing.assert_array_equal(np.asarray(jcache["slot_pos"]),
                                  tcache["slot_pos"].numpy())
    np.testing.assert_array_equal(np.asarray(jcache["pos"]),
                                  tcache["pos"].numpy())
    for key in ("k", "v"):
        assert _rel(_np(jcache[key]), tcache[key]) <= _tol(tc)


@pytest.mark.parametrize("variant", ["dense", "swa", "tied"])
def test_decode_matches_prefill_in_the_port(variant):
    """The reference's own decode-vs-prefill check, on the port alone."""
    _, tc, _, tp = _params(variant)
    toks = torch.from_numpy(_toks(2, 12))
    full, _ = ttfm.forward(tp, tc, toks)
    cache = ttfm.init_cache(tc, 2, 16, device="cpu")
    outs = []
    for t in range(12):
        lg, cache = ttfm.decode_step(tp, tc, cache, toks[:, t])
        outs.append(lg)
    assert _rel(full.numpy(), torch.stack(outs, 1)) <= TOL_FP32


def test_swa_rolling_cache_beyond_the_window():
    """Past the window the ring wraps (T = 6 slots for 20 positions): each
    step against the reference's decode step and against the port's full
    forward with SWA masking."""
    jc, tc, jp, tp = _params("dense", sliding_window=6)
    toks = _toks(1, 20)
    jcache = jtfm.init_cache(jc, 1, 20)
    tcache = ttfm.init_cache(tc, 1, 20, device="cpu")
    assert tcache["k"].shape[2] == 6 == ttfm.cache_len(tc, 20)
    full, _ = ttfm.forward(tp, tc, torch.from_numpy(toks))
    outs = []
    for t in range(20):
        jl, jcache = _jdecode(jp, jc, jcache, jnp.asarray(toks[:, t]))
        tl, tcache = ttfm.decode_step(tp, tc, tcache,
                                      torch.from_numpy(toks[:, t]))
        assert _rel(np.asarray(jl), tl) <= TOL_FP32
        outs.append(tl)
    assert _rel(full.numpy(), torch.stack(outs, 1)) <= TOL_FP32
    np.testing.assert_array_equal(np.asarray(jcache["slot_pos"]),
                                  tcache["slot_pos"].numpy())


@pytest.mark.parametrize("variant", ["dense", "tied", "bf16"])
def test_h100_model_counts_a_decode_step_from_the_params(variant):
    """``H100Model.lm_decode_step`` against the params it should count:
    each weight matrix once in the compute dtype (a tied head is the
    embedding itself), the embedding rows of the step's tokens, the norms
    in fp32, the whole cache read and this step's rows written, slot_pos,
    fp32 logits."""
    from repro_torch.common.tree import path_map
    from repro_torch.core.codesign import H100Model
    _, tc = _cfgs(variant)
    sizes = {}
    path_map(lambda path, t: sizes.__setitem__(path, t.numel()),
             ttfm.init(0, tc, device="cpu"))
    mats = sum(n for p, n in sizes.items()
               if p.endswith("/w") and p != "embed/w")
    if tc.tie_embeddings:
        mats += sizes["embed/w"]
    norms = sum(n for p, n in sizes.items() if p.endswith("/scale"))
    b, t, hd = 3, 10, tc.head_dim_
    elem = 2 if variant == "bf16" else 4
    flops, nbytes = H100Model.lm_decode_step(tc, b, t)
    kv = 2 * tc.n_layers * b * tc.n_kv_heads * hd * elem
    assert nbytes == elem * (mats + b * tc.d_model) + 4 * norms \
        + kv * (t + 1) + 4 * b * t + 4 * b * ttfm.padded_vocab(tc)
    assert flops == b * (2 * mats + tc.n_layers * 4 * tc.n_heads * hd * t)
