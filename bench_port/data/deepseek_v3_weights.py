"""DeepSeek-V3-family weights (moonlight-16b-a3b) drawn by the benchmark
from ``--seed``, on the device, in the reference's layout.

One flat dict of the reference's names (``reference/deepseek_v3.py``),
each leaf stacked over the layers that have it: ``attn_norm``,
``ffn_norm``, ``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b`` and ``wo`` over all
``num_hidden_layers``; ``w_gate``, ``w_in`` and ``w_out`` over the
``first_k_dense_replace`` dense layers; ``router_w``, ``router_bias``,
``experts_*`` and ``shared_*`` over the MoE layers; and ``embed``,
``final_norm``, ``lm_head``.  Every matrix is (in, out).

Every matrix and the embedding draw from N(0, 0.02) (DeepSeek-V3's
``_init_weights`` at its ``initializer_range``), every RMSNorm scale from
1 + N(0, 0.1), so that a scale dropped or applied to the wrong tensor
shows, and the router's correction bias from N(0, 0.1) in fp32.  The
rest is in the configuration's ``compute_dtype``.  One generator on the
device, one layer at a time, so the same seed draws the same weights
and a stacked leaf needs no copy in another dtype.

:func:`program_params` hands the same tensors to the program in its
parameter tree, :func:`reference_weights` to the reference, each layer's
cast to fp32 only when the reference asks for it.
"""

from __future__ import annotations

import torch

MATRIX_STD = 0.02
NORM_STD = 0.1
ROUTER_BIAS_STD = 0.1

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def shapes(config: dict) -> dict:
    """Name -> (shape, kind) in draw order; kind is ``matrix``, ``norm`` or
    ``bias``."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    dn, dr = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    dv, r = config["v_head_dim"], config["kv_lora_rank"]
    nl, k = config["num_hidden_layers"], config["first_k_dense_replace"]
    v, f = config["vocab_size"], config["intermediate_size"]
    e, fe = config["n_routed_experts"], config["moe_intermediate_size"]
    fs, m = config["n_shared_experts"] * fe, nl - k
    out = {
        "embed": ((v, d), "matrix"),
        "lm_head": ((d, v), "matrix"),
        "final_norm": ((d,), "norm"),
        "attn_norm": ((nl, d), "norm"),
        "ffn_norm": ((nl, d), "norm"),
        "wq": ((nl, d, h * (dn + dr)), "matrix"),
        "wkv_a": ((nl, d, r + dr), "matrix"),
        "kv_norm": ((nl, r), "norm"),
        "wkv_b": ((nl, r, h * (dn + dv)), "matrix"),
        "wo": ((nl, h * dv, d), "matrix"),
    }
    if k:
        out.update({"w_gate": ((k, d, f), "matrix"),
                    "w_in": ((k, d, f), "matrix"),
                    "w_out": ((k, f, d), "matrix")})
    out.update({
        "router_w": ((m, d, e), "matrix"),
        "router_bias": ((m, e), "bias"),
        "experts_w_gate": ((m, e, d, fe), "matrix"),
        "experts_w_in": ((m, e, d, fe), "matrix"),
        "experts_w_out": ((m, e, fe, d), "matrix"),
    })
    if fs:
        out.update({"shared_w_gate": ((m, d, fs), "matrix"),
                    "shared_w_in": ((m, d, fs), "matrix"),
                    "shared_w_out": ((m, fs, d), "matrix")})
    return out


def draw(config: dict, seed: int, device) -> dict:
    """The weights of ``config`` from ``seed`` (see the module docstring)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    dt = DTYPES[config["compute_dtype"]]
    out = {}
    for name, (shape, kind) in shapes(config).items():
        t = torch.empty(shape, dtype=torch.float32 if kind == "bias" else dt,
                        device=device)
        mean, std = {"matrix": (0.0, MATRIX_STD), "norm": (1.0, NORM_STD),
                     "bias": (0.0, ROUTER_BIAS_STD)}[kind]
        for part in (t if t.dim() > 2 else [t]):
            part.normal_(mean, std, generator=gen)
        out[name] = t
    return out


def program_params(w: dict, config: dict) -> dict:
    """The program's parameter tree over the same tensors (no copy)."""
    def mat(name):
        return {"w": w[name]}
    p = {
        "embed": mat("embed"), "lm_head": mat("lm_head"),
        "final_norm": {"scale": w["final_norm"]},
        "layers": {
            "attn_norm": {"scale": w["attn_norm"]},
            "ffn_norm": {"scale": w["ffn_norm"]},
            "attn": {"wq": mat("wq"), "wkv_a": mat("wkv_a"),
                     "kv_norm": {"scale": w["kv_norm"]},
                     "wkv_b": mat("wkv_b"), "wo": mat("wo")}},
        "moe": {"router": {"w": w["router_w"], "bias": w["router_bias"]},
                "experts": {n: w[f"experts_{n}"]
                            for n in ("w_gate", "w_in", "w_out")}},
    }
    if config["first_k_dense_replace"]:
        p["dense"] = {n: mat(n) for n in ("w_gate", "w_in", "w_out")}
    if config["n_shared_experts"]:
        p["moe"]["shared"] = {n: mat(f"shared_{n}")
                              for n in ("w_gate", "w_in", "w_out")}
    return p


def reference_weights(w: dict, config: dict):
    """The reference's ``(outer, layer)`` callables over ``w``: each call
    casts what it returns to fp32."""
    k = config["first_k_dense_replace"]

    def outer():
        return {n: w[n].float() for n in ("embed", "final_norm", "lm_head")}

    def layer(i):
        lw = {n: w[n][i].float() for n in ("attn_norm", "ffn_norm", "wq",
                                           "wkv_a", "kv_norm", "wkv_b", "wo")}
        if i < k:
            lw.update({n: w[n][i].float() for n in ("w_gate", "w_in",
                                                    "w_out")})
            return lw
        for n in ("router_w", "router_bias", "experts_w_gate",
                  "experts_w_in", "experts_w_out", "shared_w_gate",
                  "shared_w_in", "shared_w_out"):
            if n in w:
                lw[n] = w[n][i - k].float()
        return lw
    return outer, layer
