"""moonshot-v1-16b-a3b [moe] — Moonlight-16B-A3B (kimi).

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]

Simplification noted in DESIGN.md: Moonlight's dense first layer and shared
expert are folded into the uniform 64e top-6 stack (scan-stacked layers must
be homogeneous; parameter count deviation < 2%).

By count these shapes hold 28.06 B params (570.6 M a layer, 553.7 M of it
experts; 671 M in the embedding and the head), whatever the name says.
The port serves it on one card with ``param_dtype="bfloat16"`` (56.1 GB,
the same bf16 values the compute cast would make from fp32), the memory
plan ``arctic_480b.py`` uses.
"""

from repro_torch.configs.base import (
    ArchSpec, LM_SHAPES, MoEConfig, TransformerConfig,
)

MODEL = TransformerConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6),
    rope_theta=50000.0,
    activation="silu",
    remat="layer",
    param_dtype="float32",
    compute_dtype="bfloat16",
)

ARCH = ArchSpec(
    arch_id="moonshot-v1-16b-a3b",
    family="lm",
    model=MODEL,
    shapes=dict(LM_SHAPES),
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
    notes="64-expert top-6 MoE, ~3B active.",
    skipped_shapes={
        "long_500k": "pure full-attention arch: 512k decode requires "
                     "sub-quadratic attention (see DESIGN.md §Skips)",
    },
)
