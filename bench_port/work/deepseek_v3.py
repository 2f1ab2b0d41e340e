"""The work of DeepSeek-V3's decode steps and prefills, counted from the
configuration's shapes (config.json keys) so that the yardstick cannot
move with the program.

Operations are 2 per multiply-add of the products (norms, rope, softmax
and the router's sort are left out).  Decode is the absorbed form: a
token's projections (q, the latent and rope key, q_nope into the latent,
the latent out of it through W_UV, the output) and, for each cache
position it attends over, the scores over the latent and the rope key and
the product of p with the latent.  Prefill is the naive form: the same
projections with the latent's up-projection to k_nope and v in place of
the two absorbed ones, and for each causal (query, key) pair the scores
over the 192-wide head and the product with the 128-wide v.  The MoE
counts the router, the ``num_experts_per_tok`` routed SwiGLUs and the
shared SwiGLU a token; the head a token; the embedding none.  bfloat16
weights and cache: 2 bytes a value, the router's bias fp32.

At moonlight-16b-a3b: 5,158,207,488 operations a decoded token before
attention, 34,816 a cache position a layer (940,032 over 27 layers).
"""

from __future__ import annotations

BF16 = 2


def _dims(c: dict):
    h = c["num_attention_heads"]
    return (c["hidden_size"], h, c["qk_nope_head_dim"], c["qk_rope_head_dim"],
            c["v_head_dim"], c["kv_lora_rank"])


def _layers(c: dict) -> tuple[int, int]:
    k = c["first_k_dense_replace"]
    return k, c["num_hidden_layers"] - k


def _projection_ops(c: dict, absorbed: bool) -> int:
    d, h, dn, dr, dv, r = _dims(c)
    ops = 2 * d * h * (dn + dr) + 2 * d * (r + dr) + 2 * h * dv * d
    return ops + (2 * h * (dn + dv) * r if not absorbed
                  else 2 * h * dn * r + 2 * h * r * dv)


def moe_token_ops(c: dict) -> int:
    """One token through one MoE layer: router, routed and shared."""
    d, e, k = c["hidden_size"], c["n_routed_experts"], c["num_experts_per_tok"]
    f, fs = c["moe_intermediate_size"], (c["n_shared_experts"]
                                         * c["moe_intermediate_size"])
    return 2 * d * e + k * 6 * d * f + 6 * d * fs


def _token_ops(c: dict, absorbed: bool) -> int:
    n_dense, n_moe = _layers(c)
    d = c["hidden_size"]
    return (c["num_hidden_layers"] * _projection_ops(c, absorbed)
            + n_dense * 6 * d * c["intermediate_size"]
            + n_moe * moe_token_ops(c) + 2 * d * c["vocab_size"])


def latent_ops_per_position(c: dict) -> int:
    """One cache position of one layer in the absorbed attention."""
    _, h, _, dr, _, r = _dims(c)
    return 2 * h * (r + dr) + 2 * h * r


def decode_ops(c: dict, tokens: int, kv_positions: int) -> int:
    """``tokens`` decoded over ``kv_positions`` cache positions in all
    (each token's count includes its own new row)."""
    return (tokens * _token_ops(c, absorbed=True)
            + kv_positions * c["num_hidden_layers"]
            * latent_ops_per_position(c))


def prefill_ops(c: dict, length: int) -> int:
    """One prompt of ``length`` tokens (no padding) in the naive form."""
    _, h, dn, dr, dv, _ = _dims(c)
    pairs = length * (length + 1) // 2
    return (length * _token_ops(c, absorbed=False)
            + pairs * c["num_hidden_layers"] * (2 * h * (dn + dr) + 2 * h * dv))


def mla_decode_work(c: dict, tokens: int, kv_positions: int):
    """(operations, bytes) of the latent attention over the cache in all
    layers: each position's (kv_lora + rope) bf16 values read once a layer
    (1,152 B at Moonlight), and a token's new row written, its q_lat and
    q_pe read and its latent output written, once a layer."""
    _, h, _, dr, _, r = _dims(c)
    n = c["num_hidden_layers"]
    ops = kv_positions * n * latent_ops_per_position(c)
    per_token = BF16 * ((r + dr) + h * (r + dr) + h * r)
    nbytes = n * (kv_positions * BF16 * (r + dr) + tokens * per_token)
    return float(ops), float(nbytes)


def experts_touched(c: dict, tokens_per_step: float) -> float:
    """Routed experts a step of that many tokens reads, expected under
    uniform routing: E (1 - (1 - k / E)^T) (63.995 of 64 at 96 tokens)."""
    e, k = c["n_routed_experts"], c["num_experts_per_tok"]
    return e * (1.0 - (1.0 - k / e) ** tokens_per_step)


def moe_decode_work(c: dict, steps: int, tokens: int):
    """(operations, bytes) of the routed and shared experts of ``steps``
    decode steps serving ``tokens`` tokens in all, over every MoE layer:
    each touched expert's three bf16 matrices, the shared SwiGLU and the
    router read once a step a layer, and each token's input read and
    output written."""
    if steps <= 0:
        return 0.0, 0.0
    _, n_moe = _layers(c)
    d, e, f = c["hidden_size"], c["n_routed_experts"], c["moe_intermediate_size"]
    fs = c["n_shared_experts"] * f
    weights = (experts_touched(c, tokens / steps) * 3 * d * f * BF16
               + 3 * d * fs * BF16 + d * e * BF16 + e * 4)
    nbytes = n_moe * (steps * weights + tokens * 2 * d * BF16)
    return float(n_moe * tokens * moe_token_ops(c)), float(nbytes)


def parameters(c: dict) -> int:
    """Parameter count (15,960,110,208 at Moonlight)."""
    d, h, dn, dr, dv, r = _dims(c)
    n_dense, n_moe = _layers(c)
    e, f = c["n_routed_experts"], c["moe_intermediate_size"]
    attn = (d * h * (dn + dr) + d * (r + dr) + r + r * h * (dn + dv)
            + h * dv * d + 2 * d)
    moe = d * e + e + 3 * e * d * f + 3 * d * c["n_shared_experts"] * f
    return (2 * c["vocab_size"] * d + d + c["num_hidden_layers"] * attn
            + n_dense * 3 * d * c["intermediate_size"] + n_moe * moe)


def cache_bytes_per_position(c: dict) -> int:
    return c["num_hidden_layers"] * (c["kv_lora_rank"]
                                     + c["qk_rope_head_dim"]) * BF16


def roofline_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time: operations over the bf16 peak or bytes over the
    memory bandwidth, whichever is longer."""
    return max(ops / peaks["flops_per_s"]["bfloat16"],
               nbytes / peaks["bytes_per_s"])

