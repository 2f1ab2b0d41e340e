"""moonlight-16b-a3b [moe, port only] — Moonlight-16B-A3B as published.

Source: https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json
(``model_type: deepseek_v3``): 27 layers, hidden 2,048, 16 heads, an
untied vocabulary of 163,840, RMSNorm eps 1e-5, rope_theta 50,000 without
rope scaling, no q-LoRA; multi-head latent attention with kv_lora_rank
512, qk_nope 128, qk_rope 64, v_head 128; one leading dense layer of
SwiGLU width 11,264 (``first_k_dense_replace``), then 26 MoE layers of 64
routed SwiGLU experts of width 1,408 picking 6, plus 2 shared experts,
routed by a sigmoid gate with a per-expert correction bias
(``noaux_tc``, n_group 1), ``norm_topk_prob`` and
``routed_scaling_factor`` 2.446.  Multi-token prediction is absent
(``num_nextn_predict_layers`` 0).

Deployment: the whole model on one H100, nothing reduced: 15.96 B
parameters in bfloat16 (31.9 GB: 671 M in the embedding and the head,
83 M in the dense layer, 26 x 584.9 M in the MoE layers), a bfloat16
latent cache of 31,104 B a position (27 layers x (512 + 64) x 2 B).
The router's product, its sigmoid, the attention softmax and every
product's accumulation are fp32; the residual stream and the products'
outputs are bfloat16.

RoPE follows DeepSeek-V3's ``modeling_deepseek.py``: the rope part of q
and k is de-interleaved (even lanes, then odd lanes) before the
rotate-half rotation.  Random weights cannot tell the layouts apart
against a checkpoint; the port and its plain reference
(``models/plain_deepseek_v3.py``) both use this one.

Not the registry's ``moonshot-v1-16b-a3b``, which is the JAX reference's
homogeneous simplification of the same model.

The benchmark cell ``moonlight-16b-a3b.decode_8k`` holds the served
decode logits, every token served to the kept sequences and every serving
slot's first-layer latent cache rows against the plain fp32 reference
(``models/plain_deepseek_v3.py``), routed by the served expert ids, on
weights the benchmark draws itself (norm scales 1 + N(0, 0.1)).
Readings on an H100 80GB HBM3 at 700 W, 23 seeds: the logit gap 0.0291
to 0.0375 of the largest reference logit (bf16 through 27 random layers
against fp32), no served token more than 0.041 of scale below the
reference's best, no served expert's choice score more than 0.0359 below
the reference's sixth, and the latent cache 0.00288 to 0.00290 of its
norm off (bf16 rounding).  Limits 0.12, twice that for tokens, 0.11 and
0.0088.  Controls: the latent cache in fp8 e4m3 reads 0.0269 there and
fails; every weight matrix in fp8 e4m3 reads a logit gap of 0.372, the
shared experts dropped 1.16 and the routed scale 1 0.741, and all three
fail.
"""

from repro_torch.configs.base import (
    ArchSpec, MLAConfig, RoutedMoEConfig, ShapeSpec,
)

MODEL = MLAConfig(
    name="moonlight-16b-a3b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=RoutedMoEConfig(n_experts=64, top_k=6, n_shared_experts=2,
                        norm_topk_prob=True, routed_scaling_factor=2.446,
                        aux_loss_weight=0.0),
    rope_theta=50000.0,
    activation="silu",
    remat="none",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense=1,
    dense_d_ff=11264,
    norm_eps=1e-5,
)

ARCH = ArchSpec(
    arch_id="moonlight-16b-a3b",
    family="lm",
    model=MODEL,
    shapes={"decode_8k": ShapeSpec("decode_8k", "decode",
                                   dict(seq_len=8192, global_batch=96))},
    source="hf:moonshotai/Moonlight-16B-A3B; config.json",
    notes="MLA, 1 dense + 26 MoE layers (64 routed top-6 + 2 shared), "
          "sigmoid router with correction bias; ~3B active.",
)
