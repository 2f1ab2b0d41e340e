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
from repro_torch.configs.base import TransformerConfig
from repro_torch.kernels.flash_decode import kernel as FDK
from repro_torch.models import moe as moe_lib
from repro_torch.nn import core as nn
from repro_torch.nn.attention import attention, scale_q
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
            kv_chunk=2048, q_chunk=None):
    """tokens: (B, S) int -> (logits (B, S, vocab_padded), aux[, cache]),
    logits in the compute dtype."""
    cdt = nn.as_dtype(cfg.compute_dtype)
    out = forward_hidden(params, cfg, tokens, return_cache=return_cache,
                         kv_chunk=kv_chunk, q_chunk=q_chunk)
    logits = nn.dot(out[0], _head_weight(params, cfg, cdt))
    logits = constrain(logits, "tokens", None, None)
    return (logits, *out[1:])


def forward_hidden(params, cfg: TransformerConfig, tokens, *,
                   return_cache=False, kv_chunk=2048, q_chunk=None):
    """tokens: (B, S) int -> (h (B, S, d), aux_loss [, cache]); aux_loss
    is the sum of the layers' MoE aux losses (0 for a dense LM), the
    cache holds k / v stacked as (n_layers, B, S, n_kv, hd) and ``pos`` =
    S.  With ``remat="layer"``, grad mode on and a param that requires
    grad, each layer runs under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward
    instead of kept.  Serving never asks for grads, so it runs no remat."""
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
    ``pos`` (batch,) = 0, on ``device``."""
    dev = resolve_device(device)
    t = cache_len(cfg, max_seq)
    dt = nn.as_dtype(dtype or cfg.compute_dtype)
    shape = (cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
        # absolute position of each slot's entry; -1 = empty
        "slot_pos": torch.full((batch, t), -1, dtype=torch.int32, device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def decode_step(params, cfg: TransformerConfig, cache, tokens):
    """One greedy decode step. tokens: (B,) int -> (logits (B, V) fp32,
    cache).

    The cache is updated IN PLACE (this step's k / v rows and
    ``slot_pos``; ``pos`` is replaced by ``pos + 1``) and returned, where
    the reference returns a new one.  Each layer's attention is one B5
    launch on the card over that layer's whole (B, T, Hkv, D) cache after
    this step's write, with q_pos = ``pos`` and kv_pos = the updated
    ``slot_pos``.
    """
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
