"""Plain DeepSeek-V3 forward in float32: the reference the port's MLA
model (moonlight-16b-a3b) is held against.

Plain ``torch`` only, importing nothing of the port: the equations of
``modeling_deepseek.py`` (``model_type: deepseek_v3``) for one sequence
at a time, with no cache and no batching.  For a token's hidden state h:

* attention: q = W_q h, split per head into q_nope and q_pe;
  [c_kv, k_pe] = W_kva h, c_kv <- RMSNorm(c_kv); RoPE on q_pe and on the
  one k_pe all heads share, after de-interleaving the lanes (even lanes,
  then odd) as DeepSeek-V3's ``apply_rotary_pos_emb`` does;
  [k_nope, v] = W_kvb c_kv per head; scores (q_nope . k_nope + q_pe .
  k_pe) / sqrt(qk_nope + qk_rope), causal, softmax, times v, then W_o;
* FFN: SwiGLU, dense in the first ``first_k_dense_replace`` layers;
* MoE: s = sigmoid(W_g h); the top k of s + b (the correction bias);
  weights the chosen s (without b), normalised (``+ 1e-20``) when
  ``norm_topk_prob``, times ``routed_scaling_factor``; y = sum_i w_i
  E_i(h) + S(h), S the shared experts as one SwiGLU of ``n_shared_experts``
  times the expert width; no token dropped.

Departures from the published model: everything is float32 (the
checkpoint is bfloat16; :func:`fp32_products` turns TF32 off for matmul
and cuDNN), logits are computed only at the positions asked for, the
gate's group-limited choice is left out (it is the identity at
``n_group`` 1), and multi-token prediction is absent (Moonlight has no
such layer).  Attention runs in query blocks so that a long sequence
fits beside a served model.  :func:`latent` gives what a layer writes to
a latent cache (its normed c_kv and roped k_pe), :func:`head` the logits
of hidden states that ``forward(..., head=False)`` returns.

``cfg`` is a dict with the config.json keys.  Weights come from two
callables, so that a caller can cast one layer at a time: ``outer()`` ->
{"embed" (V, d), "final_norm" (d,), "lm_head" (d, V)} and ``layer(i)`` ->
{"attn_norm", "wq" (d, H (nope + rope)), "wkv_a" (d, r + rope),
"kv_norm" (r,), "wkv_b" (r, H (nope + v)), "wo" (H v, d), "ffn_norm"} plus
{"w_gate", "w_in", "w_out"} for a dense layer or {"router_w" (d, E),
"router_bias" (E,), "experts_w_gate" (E, d, f), "experts_w_in",
"experts_w_out" (E, f, d), "shared_w_gate", "shared_w_in",
"shared_w_out"} for an MoE layer, every matrix (in, out).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_products():
    """Full fp32 products inside the block (no TF32 in matmul or cuDNN)."""
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cd.allow_tf32)
    mm.allow_tf32 = cd.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cd.allow_tf32 = saved


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta: float):
    """x (S, H, D) at positions pos (S,): de-interleaved, then rotate-half
    with frequencies theta^(-2i/D)."""
    d = x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = pos.float()[:, None, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def kv_latent(lw, cfg: dict, x):
    """What one sequence's normed x (S, d) writes to a latent cache: the
    normed c_kv (S, r) and the roped k_pe (S, 1, dr) all heads share."""
    r = cfg["kv_lora_rank"]
    pos = torch.arange(x.shape[0], device=x.device)
    kv_a = x @ lw["wkv_a"]
    c_kv = rms_norm(kv_a[:, :r], lw["kv_norm"], cfg["rms_norm_eps"])
    return c_kv, rope(kv_a[:, None, r:], pos, cfg["rope_theta"])


def mla(lw, cfg: dict, x, q_block: int):
    """Naive latent attention of one sequence's normed x (S, d)."""
    s = x.shape[0]
    h, dn = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    dr, dv = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    pos = torch.arange(s, device=x.device)
    q = (x @ lw["wq"]).view(s, h, dn + dr)
    c_kv, k_pe = kv_latent(lw, cfg, x)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, cfg["rope_theta"])],
                  dim=-1)
    kv = (c_kv @ lw["wkv_b"]).view(s, h, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe.expand(s, h, dr)], dim=-1)
    v = kv[..., dn:]
    out = torch.empty((s, h, dv), dtype=x.dtype, device=x.device)
    scale = (dn + dr) ** -0.5
    for i in range(0, s, q_block):
        j = min(s, i + q_block)
        scores = torch.einsum("qhd,khd->hqk", q[i:j], k[:j]) * scale
        causal = pos[i:j, None] >= pos[None, :j]
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        out[i:j] = torch.einsum("hqk,khd->qhd", p, v[:j])
    return out.reshape(s, h * dv) @ lw["wo"]


def swiglu(x, w_gate, w_in, w_out):
    return (F.silu(x @ w_gate) * (x @ w_in)) @ w_out


class RouteCheck:
    """Served expert choices held against the reference's own: ``off_tie``
    counts those whose choice score lies more than ``band`` below the
    reference's k-th largest, ``worst`` is the widest such shortfall."""

    def __init__(self, band: float):
        self.band = float(band)
        self.off_tie = 0
        self.worst = 0.0
        self.choices = 0


def moe(lw, cfg: dict, x, *, forced=None, check: RouteCheck | None = None):
    """Dropless routed experts plus the shared experts of x (S, d).  With
    ``forced`` (S, k) expert ids the layer routes by them (the served
    choice) and ``check`` counts those that lie more than its band below
    the reference's own k-th choice score."""
    k, e = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    scores = torch.sigmoid(x @ lw["router_w"])
    choice = scores + lw["router_bias"]
    top = torch.sort(choice, dim=-1, descending=True, stable=True)
    ids = top.indices[:, :k] if forced is None else forced.long()
    if check is not None and forced is not None:
        gap = top.values[:, k - 1:k] - choice.gather(1, ids)
        check.off_tie += int((gap > check.band).sum())
        check.worst = max(check.worst, float(gap.max()))
        check.choices += ids.numel()
    w = scores.gather(1, ids)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for ex in range(e):
        tok, slot = torch.nonzero(ids == ex, as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, w[tok, slot, None] * swiglu(
                x[tok], lw["experts_w_gate"][ex], lw["experts_w_in"][ex],
                lw["experts_w_out"][ex]))
    if cfg["n_shared_experts"]:
        y = y + swiglu(x, lw["shared_w_gate"], lw["shared_w_in"],
                       lw["shared_w_out"])
    return y


def block(lw, cfg: dict, i: int, h, *, forced=None,
          check: RouteCheck | None = None, q_block: int = 1024):
    """Layer ``i`` of one sequence's hidden states h (S, d)."""
    eps = cfg["rms_norm_eps"]
    h = h + mla(lw, cfg, rms_norm(h, lw["attn_norm"], eps), q_block)
    x = rms_norm(h, lw["ffn_norm"], eps)
    if i < cfg["first_k_dense_replace"]:
        return h + swiglu(x, lw["w_gate"], lw["w_in"], lw["w_out"])
    return h + moe(lw, cfg, x, forced=forced, check=check)


def forward(outer, layer, cfg: dict, sequences, *, positions=None,
            routes=None, check: RouteCheck | None = None,
            q_block: int = 1024, head: bool = True):
    """Logits of each token sequence (a 1-D int tensor) at ``positions``
    (a list with one list of positions a sequence; default every one):
    a list of (n_positions, V) fp32 tensors; with ``head=False`` the
    final-normed hidden states (n_positions, d) there instead.

    Layer by layer over all sequences, so that ``layer(i)`` is called once
    a layer.  ``routes``: for each sequence its served expert ids (S,
    n_moe_layers, k), which the MoE layers route by (and ``check`` holds
    against the reference's own choice)."""
    with fp32_products():
        ow = outer()
        hs = [ow["embed"][seq.long()] for seq in sequences]
        k_dense = cfg["first_k_dense_replace"]
        for i in range(cfg["num_hidden_layers"]):
            lw = layer(i)
            for n, h in enumerate(hs):
                forced = (None if routes is None or i < k_dense
                          else routes[n][:, i - k_dense])
                hs[n] = block(lw, cfg, i, h, forced=forced, check=check,
                              q_block=q_block)
            del lw
        out = []
        for n, h in enumerate(hs):
            pick = slice(None) if positions is None else positions[n]
            h = rms_norm(h[pick], ow["final_norm"], cfg["rms_norm_eps"])
            out.append(h @ ow["lm_head"] if head else h)
        return out


def head(outer_weights: dict, h):
    """The logits (n, V) fp32 of final-normed hidden states h (n, d)."""
    with fp32_products():
        return h @ outer_weights["lm_head"]


def latent(outer, layer, cfg: dict, sequences, at: int, *,
           q_block: int = 1024):
    """What layer ``at`` writes to a latent cache for each token sequence:
    a list of (c_kv (S, r), k_pe (S, dr)) fp32, the layers below it run
    whole (routed by the reference's own choice)."""
    with fp32_products():
        ow = outer()
        hs = [ow["embed"][seq.long()] for seq in sequences]
        del ow
        for i in range(at):
            lw = layer(i)
            hs = [block(lw, cfg, i, h, q_block=q_block) for h in hs]
            del lw
        lw = layer(at)
        out = []
        for h in hs:
            c_kv, k_pe = kv_latent(
                lw, cfg, rms_norm(h, lw["attn_norm"], cfg["rms_norm_eps"]))
            out.append((c_kv, k_pe[:, 0]))
        return out
