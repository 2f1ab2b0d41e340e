"""Decoder-only LM family: dense + MoE, GQA, RoPE, SWA.

Port of ``repro.models.transformer`` for its five architectures: the
dense h2o-danube-1.8b, minicpm-2b and phi3-medium-14b, and the MoE
moonshot-v1-16b-a3b and arctic-480b (``models/moe.py``, with Arctic's
parallel dense residual FFN).  Entry points, as the reference's:

* ``forward``     : train / prefill logits (+ KV cache on request);
* ``loss_fn``     : next-token cross-entropy, optionally in logit chunks;
* ``init_cache``  : a (rolling, for SWA) KV cache;
* ``decode_step`` : one token per sequence against the cache.

The parameters keep the reference's layout: every leaf of ``"layers"``
is stacked over a leading ``n_layers`` axis, which a Python loop walks
(the reference's ``lax.scan``).  The reference's sharding constraints are
in place (:func:`repro_torch.parallel.sharding.constrain`, the same
logical axes): no-ops outside an ``axis_rules`` context, and a
``redistribute`` of ``DTensor`` activations inside one.
``remat="layer"`` (every LM config's) recomputes each layer in the
backward when gradients are on, as the reference's
``jax.checkpoint`` around its scan body.  Params are stored in
``param_dtype`` and cast to the compute dtype at use, as the reference's
``dense_apply`` does; :func:`compute_params` does that cast once for a
caller that runs many steps (``serving/lm.py``).

On the card the decode step's attention is one launch of kernel B5
(``kernels/flash_decode``) per layer; prefill and training attend with
the plain :func:`repro_torch.nn.attention.attention`.  The dense products
and the MoE's router and expert products stay ``torch.matmul``
(:func:`repro_torch.nn.core.dot`), as the reference leaves them to XLA.

DeepSeek-V3's decoder (an :class:`~repro_torch.configs.base.MLAConfig`,
port only: moonlight-16b-a3b) takes its own branch of ``init``,
``forward``, ``init_cache`` and ``decode_step``: multi-head latent
attention (naive in prefill; in decode the absorbed form over a cache of
the normed latent ``ckv`` and the roped key ``kpe``, as batched bf16
products with fp32 scores and softmax, masked by ``slot_pos``), one or
more leading dense layers, then the routed MoE
(:func:`repro_torch.models.moe.routed_moe_apply`).  While a profiler
records, its decode step marks each layer's latent attention and experts
with the ranges ``lm.mla`` and ``lm.moe``.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.common import prng
from repro_torch.common.tree import path_map, tree_leaves, tree_map
from repro_torch.configs.base import MLAConfig, TransformerConfig
from repro_torch.kernels.flash_decode import kernel as FDK
from repro_torch.models import moe as moe_lib
from repro_torch.nn import core as nn
from repro_torch.nn.attention import NEG_INF, attention, scale_q
from repro_torch.nn.rope import apply_rope, rope_cos_sin
from repro_torch.parallel.sharding import constrain, flatten_ready, \
    replicated, shard_block, split_reshape


def padded_vocab(cfg: TransformerConfig, multiple: int = 256) -> int:
    """The vocab rounded up to ``multiple`` (minicpm: 122,753 -> 122,880).
    Padded vocab: the padding rows are drawn like the rest and the logits
    keep them, so a greedy argmax may pick one, as the reference's may;
    nothing masks them."""
    return -(-cfg.vocab_size // multiple) * multiple


@contextlib.contextmanager
def xla_rounding():
    """Products on the card as XLA takes them, inside the block: bf16 GEMMs
    accumulate in fp32 with one rounding of the result (no
    reduced-precision split-K), fp32 GEMMs in full fp32 (no TF32).

    The two cuBLAS flags are process-wide, so the functions of this module
    leave them alone and whoever runs the LM sets them around its calls:
    :class:`repro_torch.serving.lm.LMWorkload`'s callables run inside this
    block, and a caller of :func:`forward` / :func:`decode_step` on the
    card enters it itself.  The flags are restored on exit, so the JEDI
    and FM paths of the same process keep their own settings.
    """
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32)
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32 = saved


def _dense(p, x, cdt) -> torch.Tensor:
    """The reference's ``dense_apply`` without bias: x and w cast to the
    compute dtype (a no-op on :func:`compute_params`' weights)."""
    return nn.dot(x.to(cdt), p["w"].to(cdt))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: TransformerConfig) -> dict:
    """``(group, name) -> (key index, shape, fan_in)`` of one layer's
    weights: the index into the reference's eight layer keys
    (``ks[0..3]`` attention, ``ks[5..7]`` FFN; ``ks[4]`` is the MoE's,
    whose weights :func:`moe_lib.moe_shapes` lists).  An MoE layer has
    the FFN only with Arctic's dense residual."""
    d, hd, f = cfg.d_model, cfg.head_dim_, cfg.d_ff
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    shapes = {
        ("attn", "wq"): (0, (d, n_q * hd), d),
        ("attn", "wk"): (1, (d, n_kv * hd), d),
        ("attn", "wv"): (2, (d, n_kv * hd), d),
        ("attn", "wo"): (3, (n_q * hd, d), n_q * hd),
    }
    if cfg.moe is None or cfg.moe.dense_residual:
        shapes.update({
            ("ffn", "w_gate"): (5, (d, f), d),
            ("ffn", "w_in"): (6, (d, f), d),
            ("ffn", "w_out"): (7, (f, d), f),
        })
    return shapes


def init(key_or_seed, cfg: TransformerConfig, *, device="cuda"):
    """Random params in the reference's layout on ``device``.

    ``key_or_seed`` is a key of :mod:`repro_torch.common.prng`, which
    replays the reference's ``init(jax.random.PRNGKey(s), cfg)`` (its
    splits, the vmap over the layer keys, each weight within a few ulps),
    drawn in numpy on the host; or an int, which draws with torch on the
    device (the card's way: replaying 1.83 B normals in numpy would take
    minutes), the same shapes and scales from another stream.  From a
    seed the MoE's stacked expert leaves are drawn layer by layer into a
    ``param_dtype`` tensor: moonshot's whole (48, 64, 2048, 1408) leaf in
    fp32 would be a 35 GB temporary.
    """
    if isinstance(cfg, MLAConfig):
        return _mla_init(key_or_seed, cfg, device=device)
    dev = resolve_device(device)
    pd = nn.as_dtype(cfg.param_dtype)
    v, d, n = padded_vocab(cfg), cfg.d_model, cfg.n_layers
    shapes = _layer_shapes(cfg)
    if not isinstance(key_or_seed, np.ndarray):          # a seed
        gen = torch.Generator(device=dev).manual_seed(int(key_or_seed))

        def normal(shape):
            return torch.randn(shape, generator=gen, device=gen.device,
                               dtype=torch.float32)
        embed = normal((v, d)) * 0.02
        stacked = {path: normal((n, *shape)) * (2.0 / fan_in) ** 0.5
                   for path, (_, shape, fan_in) in shapes.items()}
        head = normal((d, v)) * 0.02
        if cfg.moe is not None:
            moe = {}
            for path, (_, shape, std) in moe_lib.moe_shapes(
                    cfg.moe, d, cfg.d_ff).items():
                t = torch.empty((n, *shape), dtype=pd, device=dev)
                for i in range(n):
                    t[i] = normal(shape) * std
                moe[path] = t
    else:
        km, kl, kh = prng.split(key_or_seed, 3)
        layer_keys = [prng.split(k, 8) for k in prng.split(kl, n)]
        embed = prng.normal(km, (v, d)) * 0.02
        stacked = {path: torch.stack([prng.normal(ks[i], shape)
                                      * (2.0 / fan_in) ** 0.5
                                      for ks in layer_keys])
                   for path, (i, shape, fan_in) in shapes.items()}
        head = prng.normal(kh, (d, v)) * 0.02
        if cfg.moe is not None:
            per_layer = [moe_lib.init_moe(ks[4], cfg.moe, d, cfg.d_ff,
                                          dtype=pd, device="cpu")
                         for ks in layer_keys]
            moe = {(g, name): torch.stack([p[g][name] for p in per_layer])
                   for g, name in moe_lib.moe_shapes(cfg.moe, d, cfg.d_ff)}

    def w(t):
        return {"w": t.to(dtype=pd, device=dev)}

    def norm():
        return {"scale": torch.ones((n, d), dtype=pd, device=dev)}

    layers = {"attn_norm": norm(), "attn": {}, "ffn_norm": norm()}
    for (group, name), t in stacked.items():
        layers.setdefault(group, {})[name] = w(t)
    if cfg.moe is not None:
        layers["moe"] = {"router": {}, "experts": {}}
        for (group, name), t in moe.items():
            layers["moe"][group][name] = t.to(dtype=pd, device=dev)
    params = {"embed": w(embed), "layers": layers,
              "final_norm": nn.rmsnorm_init(d, dtype=pd, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = w(head)
    return params


def compute_params(params, cfg: TransformerConfig):
    """``params`` with every weight matrix (the ``"w"`` leaves: dense
    layers, embedding, LM head, MoE router; and the experts' ``w_gate`` /
    ``w_in`` / ``w_out``, 97% of moonshot's params) cast to the compute
    dtype, once (a no-op on weights already in it).

    The per-call weight cast: the reference's ``dense_apply`` casts the
    fp32 params on every call, and its serving closes them into
    ``jax.jit``, so XLA folds that cast once.  Eagerly, re-casting
    danube's 7.3 GB of fp32 every decode step would cost more than the
    step, so a server casts here once and steps on the result.  The norm
    scales stay fp32, as the reference reads them.
    """
    cdt = nn.as_dtype(cfg.compute_dtype)

    def cast(path, t):
        *_, group, name = ("", *path.split("/"))
        return t.to(cdt) if name == "w" or group == "experts" else t
    return path_map(cast, params)


def _layer(layers, i: int):
    """Layer ``i``'s params: a view of each stacked leaf."""
    return tree_map(lambda t: t[i], layers)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _decode_attention(q, k_cache, v_cache, q_pos, kv_pos,
                      cfg: TransformerConfig):
    """One-token attention of q (B, 1, H, D) over one layer's cache
    (B, T, Hkv, D): kernel B5 on the card, its plain version on the CPU.

    Rounding of q: q is scaled in its own dtype, as the reference's
    ``attention`` scales it (``scale_q``), and handed to B5 as the fp32
    values of that rounded q.  B5 then keeps p at fp32 accuracy where the
    reference casts p to the compute dtype before the PV product: in fp32
    the two agree to summation order, in bf16 they differ by bf16
    roundings of p.  The fp32 output is cast to v's dtype, as the
    reference's ``attention`` returns it.
    """
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    qg = scale_q(q).float().reshape(b, hkv, h // hkv, d)
    o = FDK.flash_decode_kernel_call(qg, k_cache, v_cache, q_pos, kv_pos,
                                     window=cfg.sliding_window)
    return o.reshape(b, 1, h, d).to(v_cache.dtype)


def _sharded_decode(q, k, v, k_cache, v_cache, slot_pos, cur,
                    cfg: TransformerConfig):
    """One layer's cache write and attention for a ``DTensor`` cache
    (``parallel.sharding.kv_cache_shardings``), on each rank's local
    shards: B5 is a launch on the card's own memory, which a ``DTensor``
    cannot reach.

    q (B, 1, H, D) and this step's k / v (B, 1, Hkv, D) are laid out as
    the cache: the batch over the cache's batch mesh dims, the heads over
    ``model`` where the cache shards its kv-heads (H = G x Hkv heads kept
    in kv-head order, so each rank's q heads are the groups of its kv
    heads).  Each rank writes its sequences' rows into its shard of the
    cache and runs B5 on it; the output comes back as a ``DTensor`` of
    q's placements.

    * kv-heads sharded: each rank holds whole sequences of its batch
      rows and heads, so the local B5 is exact.
    * sequence sharded (the ``kvlen`` fallback, e.g. 8 kv heads on a
      16-way ``model``): a rank writes a row only where its block of the
      sequence holds the slot, and the sequence is then GATHERED whole
      (an all-gather of this layer's cache over the sequence's mesh
      dims) for B5.  Combining per-rank partials instead would need B5's
      softmax carries (max, sum), which its interface does not return.
    """
    mesh = k_cache.device_mesh
    cpl = tuple(k_cache.placements)
    if tuple(slot_pos.placements)[:1] != cpl[:1] \
            or tuple(cur.placements) != tuple(slot_pos.placements):
        raise ValueError(f"slot_pos {slot_pos.placements} and pos "
                         f"{cur.placements} must share the cache's batch "
                         f"placements {cpl}")
    qpl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                else Replicate() for p in cpl)
    q, k, v = (x if tuple(x.placements) == qpl
               else x.redistribute(mesh, qpl) for x in (q, k, v))
    kc, vc = k_cache.to_local(), v_cache.to_local()
    c = cur.to_local()
    t = slot_pos.shape[1]
    slot = (c % t).long()
    ar = torch.arange(kc.shape[0], device=kc.device)
    k_new = k.to_local()[:, 0].to(kc.dtype)
    v_new = v.to_local()[:, 0].to(vc.dtype)
    seq = [i for i, p in enumerate(cpl) if isinstance(p, Shard)
           and p.dim == 1]
    if seq:
        lo, n = shard_block(t, mesh, cpl, 1)
        j = slot - lo
        mine = ((j >= 0) & (j < n))[:, None, None]
        j = j.clamp(0, max(n - 1, 0))
        kc[ar, j] = torch.where(mine, k_new, kc[ar, j])
        vc[ar, j] = torch.where(mine, v_new, vc[ar, j])
        whole = tuple(Replicate() if i in seq else p
                      for i, p in enumerate(cpl))
        kc, vc = (DTensor.from_local(x, mesh, cpl, run_check=False)
                  .redistribute(mesh, whole).to_local() for x in (kc, vc))
    else:
        kc[ar, slot] = k_new
        vc[ar, slot] = v_new
    o = _decode_attention(q.to_local(), kc, vc, c, slot_pos.to_local(), cfg)
    return DTensor.from_local(o, mesh, qpl, run_check=False,
                              shape=q.shape, stride=q.stride())


def _attn_block(lp, cfg: TransformerConfig, h, q_pos, rope, *, cache=None,
                kv_chunk=None, q_chunk=None):
    """h: (B, S, d) -> (attn_out, kv); ``rope`` = the (cos, sin) tables of
    ``q_pos``, made once per forward or decode step, the same for every
    layer.

    Without a cache: self-attention over h's own (rope'd) keys; kv is the
    (k, v) pair for prefill cache building.  With ``cache = (k_cache,
    v_cache, slot_pos, rows)`` (one layer's, S = 1; ``rows`` = (batch
    index, write index) of this step's row): writes this step's k/v into
    the cache slot IN PLACE and attends over the whole cache through B5;
    kv is the (updated) cache pair.
    """
    cdt = nn.as_dtype(cfg.compute_dtype)
    b, s, _ = h.shape
    hd, n_q, n_kv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads

    x = nn.rmsnorm_apply(lp["attn_norm"], h)
    q = split_reshape(_dense(lp["attn"]["wq"], x, cdt), (b, s, n_q, hd), 2,
                      n_q)
    k = split_reshape(_dense(lp["attn"]["wk"], x, cdt), (b, s, n_kv, hd),
                      2, n_kv)
    v = split_reshape(_dense(lp["attn"]["wv"], x, cdt), (b, s, n_kv, hd),
                      2, n_kv)

    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)

    if cache is not None:
        # Functional cache updates: the reference rewrites the cache with
        # .at[].set per layer; the port writes this step's row in place.
        k_cache, v_cache, slot_pos, rows = cache
        if isinstance(k_cache, DTensor):
            o = _sharded_decode(q, k, v, k_cache, v_cache, slot_pos,
                                q_pos[:, 0], cfg)
        else:
            k_cache[rows] = k[:, 0].to(k_cache.dtype)
            v_cache[rows] = v[:, 0].to(v_cache.dtype)
            o = _decode_attention(q, k_cache, v_cache, q_pos[:, 0],
                                  slot_pos, cfg)
        kv_out = (k_cache, v_cache)
    else:
        o = attention(q, k, v, q_pos=q_pos, kv_pos=q_pos, causal=True,
                      window=cfg.sliding_window, kv_chunk=kv_chunk,
                      q_chunk=q_chunk)
        kv_out = (k, v)
    o = constrain(o, "batch", None, "heads", None)
    out = _dense(lp["attn"]["wo"],
                 split_reshape(o, (b, s, n_q * hd), 2, n_q), cdt)
    return out, kv_out


def _dense_ffn(lp, cfg: TransformerConfig, x):
    cdt = nn.as_dtype(cfg.compute_dtype)
    act = nn.ACTIVATIONS[cfg.activation]
    g = _dense(lp["w_gate"], x, cdt)
    u = _dense(lp["w_in"], x, cdt)
    mid = constrain(act(g) * u, "batch", None, "mlp")
    return _dense(lp["w_out"], mid, cdt)


def _layer_fn(lp, cfg: TransformerConfig, h, q_pos, rope, *, cache=None,
              kv_chunk=None, q_chunk=None):
    """One transformer block. Returns (h, kv, aux_loss); the MoE takes
    the block's B * S tokens as one (T, d) batch; a dense block's aux is
    None (no device op for a zero in every layer of every decode step)."""
    cdt = nn.as_dtype(cfg.compute_dtype)
    attn_out, kv = _attn_block(lp, cfg, h, q_pos, rope, cache=cache,
                               kv_chunk=kv_chunk, q_chunk=q_chunk)
    h = constrain(h + attn_out, "batch", "seq", None)
    x = nn.rmsnorm_apply(lp["ffn_norm"], h)
    if cfg.moe is not None:
        b, s, d = x.shape
        xt = constrain(flatten_ready(x, 0, 1).reshape(b * s, d), "tokens",
                       None)
        y, aux = moe_lib.moe_apply(lp["moe"], cfg.moe, xt,
                                   compute_dtype=cdt,
                                   activation=cfg.activation)
        # its grad is flattened back by the view's backward
        y = flatten_ready(split_reshape(y, (b, s, d), 0, b), 0, 1)
        if cfg.moe.dense_residual:
            y = y + _dense_ffn(lp["ffn"], cfg, x)
    else:
        y, aux = _dense_ffn(lp["ffn"], cfg, x), None
    h = constrain(h + y.to(h.dtype), "batch", "seq", None)
    return h, kv, aux


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed(params, tokens, cdt):
    """The token rows of the embedding (``jnp.take``) through
    ``F.embedding``.  A sharded table is gathered whole first (a
    redistribution seam): ``DTensor``'s rules for a gather from a
    vocab-sharded table with sharded ids fail (torch 2.11's ``index_put``
    backward, 2.13's masked partial), and ``F.embedding``'s backward
    has a rule where indexing's ``index_put`` does not in 2.11."""
    return F.embedding(tokens.long(), replicated(params["embed"]["w"])
                       ).to(cdt)


def _head_weight(params, cfg: TransformerConfig, cdt):
    # tied embeddings (minicpm): the head is embed.T
    w = (params["embed"]["w"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    return w.to(cdt)


def forward(params, cfg: TransformerConfig, tokens, *, return_cache=False,
            kv_chunk=2048, q_chunk=None, route=None):
    """tokens: (B, S) int -> (logits (B, S, vocab_padded), aux[, cache]),
    logits in the compute dtype.  ``route`` (MLA configs only): a
    (B * S, n_moe_layers, top_k) view of a :class:`moe_lib.RouteRecord`
    that receives the experts each token chose."""
    cdt = nn.as_dtype(cfg.compute_dtype)
    out = forward_hidden(params, cfg, tokens, return_cache=return_cache,
                         kv_chunk=kv_chunk, q_chunk=q_chunk, route=route)
    logits = nn.dot(out[0], _head_weight(params, cfg, cdt))
    logits = constrain(logits, "tokens", None, None)
    return (logits, *out[1:])


def forward_hidden(params, cfg: TransformerConfig, tokens, *,
                   return_cache=False, kv_chunk=2048, q_chunk=None,
                   route=None):
    """tokens: (B, S) int -> (h (B, S, d), aux_loss [, cache]); aux_loss
    is the sum of the layers' MoE aux losses (0 for a dense LM), the
    cache holds k / v stacked as (n_layers, B, S, n_kv, hd) and ``pos`` =
    S.  With ``remat="layer"``, grad mode on and a param that requires
    grad, each layer runs under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward
    instead of kept.  Serving never asks for grads, so it runs no remat.
    An MLA config's cache holds ``ckv`` (n_layers, B, S, kv_lora_rank) and
    ``kpe`` (n_layers, B, S, qk_rope_head_dim) in place of k / v."""
    if isinstance(cfg, MLAConfig):
        return _mla_forward_hidden(params, cfg, tokens,
                                   return_cache=return_cache,
                                   kv_chunk=kv_chunk, q_chunk=q_chunk,
                                   route=route)
    if route is not None:
        raise ValueError("a route record needs an MLA config's routed MoE")
    cdt = nn.as_dtype(cfg.compute_dtype)
    b, s = tokens.shape
    h = constrain(_embed(params, tokens, cdt), "batch", "seq", None)
    q_pos = torch.arange(s, dtype=torch.int32,
                         device=tokens.device)[None].expand(b, s)
    rope = rope_cos_sin(q_pos, cfg.head_dim_, cfg.rope_theta)
    remat = cfg.remat == "layer" and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))
    ks, vs, auxes = [], [], []
    for i in range(cfg.n_layers):
        body = functools.partial(_layer_fn, _layer(params["layers"], i), cfg,
                                 q_pos=q_pos, rope=rope, kv_chunk=kv_chunk,
                                 q_chunk=q_chunk)
        if remat:
            h, (k, v), aux = checkpoint(body, h, use_reentrant=False)
        else:
            h, (k, v), aux = body(h)
        auxes.append(aux)
        if return_cache:
            ks.append(k)
            vs.append(v)
    h = nn.rmsnorm_apply(params["final_norm"], h)
    aux = (torch.stack(auxes).sum() if cfg.moe is not None else
           torch.zeros((), dtype=torch.float32, device=tokens.device))
    if return_cache:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "pos": torch.full((b,), s, dtype=torch.int32,
                                   device=tokens.device)}
        return h, aux, cache
    return h, aux


def _chunk_nll(h_chunk, labels_chunk, head_w):
    """CE sum and token count of one (B, sc, d) hidden chunk."""
    logits = nn.dot(h_chunk, head_w).float()                 # (B, sc, V)
    logits = constrain(logits, "tokens", None, None)
    logz = torch.logsumexp(logits, dim=-1)
    idx = labels_chunk.clamp_min(0).long()[..., None]
    if isinstance(logits, DTensor):
        # the ids laid out as the logits' rows: a local gather, where
        # DTensor may shard the vocab and mask (a rule that fails on the
        # 2 x 16 x 16 mesh)
        idx = idx.redistribute(logits.device_mesh, logits.placements)
    gold = torch.gather(logits, -1, idx)[..., 0]
    mask = (labels_chunk >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def loss_fn(params, cfg: TransformerConfig, batch, *, kv_chunk=2048,
            q_chunk=None, logit_chunk=None):
    """Next-token cross-entropy; labels = batch["labels"] (B, S), -1
    ignored.  ``logit_chunk`` takes the LM head and the CE over sequence
    chunks, so the (B, S, V) fp32 logits never exist at once (the
    reference also remats each chunk in its backward; autograd here keeps
    each chunk's logits for it)."""
    cdt = nn.as_dtype(cfg.compute_dtype)
    h, aux = forward_hidden(params, cfg, batch["tokens"],
                            kv_chunk=kv_chunk, q_chunk=q_chunk)
    labels = batch["labels"]
    head_w = _head_weight(params, cfg, cdt)
    s = labels.shape[1]
    if logit_chunk is None or s <= logit_chunk:
        nll_sum, n_tok = _chunk_nll(h, labels, head_w)
    else:
        if s % logit_chunk:
            raise ValueError(f"sequence {s} is not a multiple of "
                             f"logit_chunk {logit_chunk}")
        nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        n_tok = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(0, s, logit_chunk):
            ns, nt = _chunk_nll(h[:, c:c + logit_chunk],
                                labels[:, c:c + logit_chunk], head_w)
            nll_sum, n_tok = nll_sum + ns, n_tok + nt
    loss = nll_sum / n_tok.clamp_min(1.0)
    return loss + aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: cache + decode
# ---------------------------------------------------------------------------

def cache_len(cfg: TransformerConfig, max_seq: int) -> int:
    """Rolling window for SWA archs — the sub-quadratic long-context path."""
    if cfg.sliding_window is not None:
        return min(max_seq, cfg.sliding_window)
    return max_seq


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype=None, *, device="cuda"):
    """k / v (n_layers, batch, T, n_kv, hd) zeros in ``dtype`` (the
    compute dtype by default), ``slot_pos`` (batch, T) = -1 (empty) and
    ``pos`` (batch,) = 0, on ``device``.  An MLA config's cache holds the
    latent ``ckv`` (n_layers, batch, T, kv_lora_rank) and the rope key
    ``kpe`` (n_layers, batch, T, qk_rope_head_dim) in place of k / v: 31,104
    B a position at moonlight-16b-a3b in bf16."""
    dev = resolve_device(device)
    t = cache_len(cfg, max_seq)
    dt = nn.as_dtype(dtype or cfg.compute_dtype)
    if isinstance(cfg, MLAConfig):
        layers = {
            "ckv": (cfg.n_layers, batch, t, cfg.kv_lora_rank),
            "kpe": (cfg.n_layers, batch, t, cfg.qk_rope_head_dim)}
    else:
        shape = (cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.head_dim_)
        layers = {"k": shape, "v": shape}
    return {
        **{key: torch.zeros(shape, dtype=dt, device=dev)
           for key, shape in layers.items()},
        # absolute position of each slot's entry; -1 = empty
        "slot_pos": torch.full((batch, t), -1, dtype=torch.int32, device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def decode_step(params, cfg: TransformerConfig, cache, tokens, *,
                route=None):
    """One greedy decode step. tokens: (B,) int -> (logits (B, V) fp32,
    cache).

    The cache is updated IN PLACE (this step's k / v rows and
    ``slot_pos``; ``pos`` is replaced by ``pos + 1``) and returned, where
    the reference returns a new one.  Each layer's attention is one B5
    launch on the card over that layer's whole (B, T, Hkv, D) cache after
    this step's write, with q_pos = ``pos`` and kv_pos = the updated
    ``slot_pos``.  An MLA config decodes over its latent cache
    (:func:`_mla_decode_step`), ``route`` receiving its experts' ids.
    """
    if isinstance(cfg, MLAConfig):
        return _mla_decode_step(params, cfg, cache, tokens, route=route)
    if route is not None:
        raise ValueError("a route record needs an MLA config's routed MoE")
    cdt = nn.as_dtype(cfg.compute_dtype)
    b = tokens.shape[0]
    t = cache["k"].shape[2]
    cur = cache["pos"]                                  # (B,)
    # The rolling SWA cache: slot pos % T, slot_pos updated before the
    # layers run; entries past the window are masked by
    # (q_pos - kv_pos) < window, in the reference and in B5 alike.
    if isinstance(cache["k"], DTensor):
        # each rank writes its own sequences' slots (_sharded_decode)
        rows = None
        sp = cache["slot_pos"].to_local()
        c = cur.to_local()
        sp[torch.arange(sp.shape[0], device=sp.device), (c % t).long()] = c
    else:
        rows = (torch.arange(b, device=tokens.device), (cur % t).long())
        cache["slot_pos"][rows] = cur
    h = constrain(_embed(params, tokens[:, None], cdt), "batch", None, None)
    q_pos = cur[:, None]
    rope = rope_cos_sin(q_pos, cfg.head_dim_, cfg.rope_theta)
    for i in range(cfg.n_layers):
        h, _, _ = _layer_fn(_layer(params["layers"], i), cfg, h, q_pos,
                            rope, cache=(cache["k"][i], cache["v"][i],
                                         cache["slot_pos"], rows))
    h = nn.rmsnorm_apply(params["final_norm"], h)
    logits = nn.dot(h, _head_weight(params, cfg, cdt))[:, 0, :]
    cache["pos"] = cur + 1
    return logits.float(), cache


# ---------------------------------------------------------------------------
# DeepSeek-V3: multi-head latent attention, leading dense layers, routed MoE
# ---------------------------------------------------------------------------

#: Query block of MLA's prefill attention: the (heads, q, kv block) fp32
#: scores of an 8,192-token prompt stay at 134 MB a block.
MLA_Q_CHUNK = 1024

#: Std of the random init of every MLA-model matrix: the
#: ``initializer_range`` of DeepSeek-V3's ``_init_weights`` (0.02).  He's
#: sqrt(2 / fan_in) makes the random 27-layer stack chaotic enough that
#: bf16 serving drifts ~7% of the largest logit from fp32 (PERF.md §6).
MLA_INIT_STD = 0.02

_NO_RANGE = contextlib.nullcontext()


def _range(name: str):
    """A ``record_function`` range while a profiler records, else a shared
    no-op (one check of the profiler's state), as
    ``serving.metrics.ServingMetrics.span``."""
    if torch._C._autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _NO_RANGE


def mla_shapes(cfg: MLAConfig) -> dict:
    """Path -> (shape, std, dtype) of every parameter of an MLA model
    (``std`` None: a norm scale of ones; ``dtype`` None: ``param_dtype``).
    Every matrix and the embedding draw from N(0, :data:`MLA_INIT_STD`),
    DeepSeek-V3's own init; the router's correction bias (fp32) from
    N(0, ``moe.ROUTER_BIAS_STD``).  Stacked leaves lead with their layer
    axis: ``layers`` over all ``n_layers``, ``dense`` over the
    ``first_k_dense`` leading layers, ``moe`` over the rest."""
    d, h, nl = cfg.d_model, cfg.n_heads, cfg.n_layers
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    v, f, k = padded_vocab(cfg), cfg.dense_d_ff, cfg.first_k_dense
    hq, hkv, ho = h * cfg.qk_head_dim, h * (cfg.qk_nope_head_dim
                                            + cfg.v_head_dim), h * cfg.v_head_dim
    std = MLA_INIT_STD
    shapes = {
        "embed/w": ((v, d), std, None),
        "lm_head/w": ((d, v), std, None),
        "final_norm/scale": ((d,), None, None),
        "layers/attn_norm/scale": ((nl, d), None, None),
        "layers/ffn_norm/scale": ((nl, d), None, None),
        "layers/attn/wq/w": ((nl, d, hq), std, None),
        "layers/attn/wkv_a/w": ((nl, d, r + dr), std, None),
        "layers/attn/kv_norm/scale": ((nl, r), None, None),
        "layers/attn/wkv_b/w": ((nl, r, hkv), std, None),
        "layers/attn/wo/w": ((nl, ho, d), std, None),
    }
    if k:
        shapes.update({
            "dense/w_gate/w": ((k, d, f), std, None),
            "dense/w_in/w": ((k, d, f), std, None),
            "dense/w_out/w": ((k, f, d), std, None),
        })
    for (group, name), shape in moe_lib.routed_moe_shapes(
            cfg.moe, d, cfg.d_ff).items():
        path = f"moe/{group}/{name}" + ("/w" if group == "shared" else "")
        if name == "bias":
            shapes[path] = ((cfg.n_moe_layers, *shape),
                            moe_lib.ROUTER_BIAS_STD, torch.float32)
        else:
            shapes[path] = ((cfg.n_moe_layers, *shape), std, None)
    return shapes


def _mla_init(seed, cfg: MLAConfig, *, device="cuda"):
    """Random params of an MLA model from an int seed, drawn by torch on
    ``device`` one layer at a time (no fp32 copy of a stacked leaf)."""
    if isinstance(seed, np.ndarray):
        raise ValueError("an MLA config has no reference init to replay: "
                         "draw it from an int seed")
    dev = resolve_device(device)
    pd = nn.as_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params: dict = {}
    for path, (shape, std, dtype) in mla_shapes(cfg).items():
        t = torch.empty(shape, dtype=dtype or pd, device=dev)
        if std is None:
            t.fill_(1.0)
        elif path.split("/")[0] in ("layers", "dense", "moe"):
            for i in range(shape[0]):
                t[i] = torch.randn(shape[1:], generator=gen, device=dev) * std
        else:
            t.copy_(torch.randn(shape, generator=gen, device=dev) * std)
        node = params
        *groups, leaf = path.split("/")
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = t
    return params


def _deinterleave(x):
    """DeepSeek-V3's rope layout: the even lanes, then the odd lanes, so
    that the rotate-half rotation pairs lanes (2i, 2i + 1)."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def _bmm_f32(a, b):
    """``a @ b`` (batched) with an fp32 result: exact products of the
    operands summed in fp32, without the bf16 rounding of the output."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _write_rows(cache, rows, x) -> None:
    """This step's rows into one layer's cache, in the cache's dtype (a
    1-byte cache such as fp8 through its bytes: ``index_put`` has no
    float8 kernel)."""
    if cache.element_size() == 1 and cache.dtype != x.dtype:
        cache.view(torch.uint8)[rows] = x.to(cache.dtype).view(torch.uint8)
    else:
        cache[rows] = x.to(cache.dtype)


def latent_attention(q_lat, q_pe, ckv, kpe, valid, scale: float):
    """One token's absorbed MLA attention over one layer's latent cache.

    q_lat (B, H, r) and q_pe (B, H, dr) in the compute dtype; ckv (B, T, r),
    kpe (B, T, dr); valid (B, T) bool.  Scores q_lat . ckv + q_pe . kpe in
    fp32, scaled, masked, an fp32 softmax, then p (cast to the compute
    dtype) times ckv: (B, H, r) in the compute dtype."""
    cdt = q_lat.dtype
    ckv, kpe = ckv.to(cdt), kpe.to(cdt)
    s = _bmm_f32(q_lat, ckv.transpose(1, 2)) \
        + _bmm_f32(q_pe, kpe.transpose(1, 2))
    s = (s * scale).masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.bmm(p.to(cdt), ckv)


def _mla_attn(lp, cfg: MLAConfig, h, q_pos, rope, *, cache=None,
              kv_chunk=None, q_chunk=None):
    """h: (B, S, d) -> (attn_out, (ckv, kpe)).  Without a cache: the naive
    form (k_nope and v up-projected from the latent for every position,
    ``attention`` over q = [q_nope, q_pe] and k = [k_nope, kpe]); the
    returned ``ckv`` / ``kpe`` are this sequence's, for the prefill cache.
    With ``cache = (ckv_cache, kpe_cache, slot_pos, rows)`` (S = 1): this
    step's rows are written in place and the absorbed form attends over
    the whole latent cache (:func:`latent_attention`)."""
    cdt = nn.as_dtype(cfg.compute_dtype)
    b, s, _ = h.shape
    nh, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    a = lp["attn"]
    x = nn.rmsnorm_apply(lp["attn_norm"], h, eps=cfg.norm_eps)
    q_nope, q_pe = _dense(a["wq"], x, cdt).view(b, s, nh, dn + dr).split(
        [dn, dr], dim=-1)
    c_kv, k_pe = _dense(a["wkv_a"], x, cdt).split([r, dr], dim=-1)
    c_kv = nn.rmsnorm_apply(a["kv_norm"], c_kv, eps=cfg.norm_eps)
    cos, sin = rope
    q_pe = apply_rope(_deinterleave(q_pe), cos, sin)
    k_pe = apply_rope(_deinterleave(k_pe)[:, :, None], cos, sin)[:, :, 0]
    w_kvb = a["wkv_b"]["w"].to(cdt)
    if cache is None:
        k_nope, v = nn.dot(c_kv, w_kvb).view(b, s, nh, dn + dv).split(
            [dn, dv], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(b, s, nh, dr)], dim=-1)
        o = attention(q, k, v, q_pos=q_pos, kv_pos=q_pos, causal=True,
                      kv_chunk=kv_chunk, q_chunk=q_chunk)
        kv_out = (c_kv, k_pe)
    else:
        ckv_cache, kpe_cache, slot_pos, rows = cache
        w = w_kvb.view(r, nh, dn + dv)
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w[..., :dn])
        with _range("lm.mla"):
            _write_rows(ckv_cache, rows, c_kv[:, 0])
            _write_rows(kpe_cache, rows, k_pe[:, 0])
            o_lat = latent_attention(q_lat, q_pe[:, 0], ckv_cache, kpe_cache,
                                     slot_pos >= 0, (dn + dr) ** -0.5)
        o = torch.einsum("bhr,rhd->bhd", o_lat, w[..., dn:])[:, None]
        kv_out = (ckv_cache, kpe_cache)
    return _dense(a["wo"], o.reshape(b, s, nh * dv), cdt), kv_out


def _mla_layer(params, cfg: MLAConfig, i: int, h, q_pos, rope, *,
               cache=None, route=None, kv_chunk=None, q_chunk=None):
    """Layer ``i``: MLA, then the dense SwiGLU (``i < first_k_dense``) or
    the routed MoE over the block's B * S tokens.  Returns (h, kv)."""
    cdt = nn.as_dtype(cfg.compute_dtype)
    lp = _layer(params["layers"], i)
    attn_out, kv = _mla_attn(lp, cfg, h, q_pos, rope, cache=cache,
                             kv_chunk=kv_chunk, q_chunk=q_chunk)
    h = h + attn_out
    x = nn.rmsnorm_apply(lp["ffn_norm"], h, eps=cfg.norm_eps)
    if i < cfg.first_k_dense:
        y = _dense_ffn(_layer(params["dense"], i), cfg, x)
    else:
        j = i - cfg.first_k_dense
        b, s, d = x.shape
        with _range("lm.moe") if cache is not None else _NO_RANGE:
            y = moe_lib.routed_moe_apply(
                _layer(params["moe"], j), cfg.moe, x.reshape(b * s, d),
                compute_dtype=cdt, activation=cfg.activation,
                route=None if route is None else route[:, j]).view(b, s, d)
    return h + y.to(h.dtype), kv


def _mla_forward_hidden(params, cfg: MLAConfig, tokens, *, return_cache,
                        kv_chunk, q_chunk, route):
    cdt = nn.as_dtype(cfg.compute_dtype)
    b, s = tokens.shape
    h = _embed(params, tokens, cdt)
    q_pos = torch.arange(s, dtype=torch.int32,
                         device=tokens.device)[None].expand(b, s)
    rope = rope_cos_sin(q_pos, cfg.qk_rope_head_dim, cfg.rope_theta)
    ckvs, kpes = [], []
    for i in range(cfg.n_layers):
        h, (ckv, kpe) = _mla_layer(params, cfg, i, h, q_pos, rope,
                                   route=route, kv_chunk=kv_chunk,
                                   q_chunk=q_chunk or MLA_Q_CHUNK)
        if return_cache:
            ckvs.append(ckv)
            kpes.append(kpe)
    h = nn.rmsnorm_apply(params["final_norm"], h, eps=cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if return_cache:
        cache = {"ckv": torch.stack(ckvs), "kpe": torch.stack(kpes),
                 "pos": torch.full((b,), s, dtype=torch.int32,
                                   device=tokens.device)}
        return h, aux, cache
    return h, aux


def _mla_decode_step(params, cfg: MLAConfig, cache, tokens, *, route=None):
    """:func:`decode_step` over an MLA config's latent cache: this step's
    ``slot_pos`` written first, then every layer writes its (ckv, kpe)
    row and attends over the whole cache in the absorbed form."""
    cdt = nn.as_dtype(cfg.compute_dtype)
    b = tokens.shape[0]
    t = cache["ckv"].shape[2]
    cur = cache["pos"]
    rows = (torch.arange(b, device=tokens.device), (cur % t).long())
    cache["slot_pos"][rows] = cur
    h = _embed(params, tokens[:, None], cdt)
    q_pos = cur[:, None]
    rope = rope_cos_sin(q_pos, cfg.qk_rope_head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        h, _ = _mla_layer(params, cfg, i, h, q_pos, rope, route=route,
                          cache=(cache["ckv"][i], cache["kpe"][i],
                                 cache["slot_pos"], rows))
    h = nn.rmsnorm_apply(params["final_norm"], h, eps=cfg.norm_eps)
    logits = nn.dot(h, _head_weight(params, cfg, cdt))[:, 0, :]
    cache["pos"] = cur + 1
    return logits.float(), cache
