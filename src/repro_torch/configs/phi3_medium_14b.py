"""phi3-medium-14b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""

from repro_torch.configs.base import ArchSpec, LM_SHAPES, TransformerConfig

MODEL = TransformerConfig(
    name="phi3-medium-14b",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=10000.0,
    activation="silu",
    remat="layer",
    param_dtype="float32",
    compute_dtype="bfloat16",
)

ARCH = ArchSpec(
    arch_id="phi3-medium-14b",
    family="lm",
    model=MODEL,
    shapes=dict(LM_SHAPES),
    source="arXiv:2404.14219; unverified",
    notes="Dense 14B; largest dense FFN of the assigned set.",
    skipped_shapes={
        "long_500k": "pure full-attention arch: 512k decode requires "
                     "sub-quadratic attention (see DESIGN.md §Skips)",
    },
)
