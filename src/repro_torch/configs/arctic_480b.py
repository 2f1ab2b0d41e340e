"""arctic-480b [moe] — Snowflake Arctic base (dense-MoE hybrid).

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 with a
parallel dense residual FFN.  [hf:Snowflake/snowflake-arctic-base; hf]

~479B total / ~17B active params.  Training memory plan for 256 x 16GiB
chips: bf16 params fully sharded over (data x model) = ~3.7 GiB/chip, bf16
grads ~3.7 GiB, Adafactor (factored second moment) states ~MBs — AdamW's
fp32 m/v (3.8 TiB global) cannot fit this pod, which is exactly the
distributed-optimization trade the config encodes.

The port runs it at tiny widths only: one of its 35 layers holds 13.4 B
expert params, more than one card serves.
"""

from repro_torch.configs.base import (
    ArchSpec, LM_SHAPES, MoEConfig, TransformerConfig,
)

MODEL = TransformerConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, dense_residual=True),
    rope_theta=10000.0,
    activation="silu",
    remat="layer",
    param_dtype="bfloat16",     # see memory plan above
    compute_dtype="bfloat16",
)

ARCH = ArchSpec(
    arch_id="arctic-480b",
    family="lm",
    model=MODEL,
    shapes=dict(LM_SHAPES),
    source="hf:Snowflake/snowflake-arctic-base; hf",
    notes="128-expert top-2 MoE + dense residual branch per layer.",
    skipped_shapes={
        "long_500k": "pure full-attention arch: 512k decode requires "
                     "sub-quadratic attention (see DESIGN.md §Skips)",
    },
)
