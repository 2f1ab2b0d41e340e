"""minicpm-2b [dense] — llama-like arch trained with the WSD schedule.

40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753.
[arXiv:2404.06395; hf]

The WSD (warmup-stable-decay) LR schedule the paper introduces is
``training/schedule.py``'s ``wsd``.  vocab 122753 pads to 122880 for
256-way sharding.
"""

from repro_torch.configs.base import ArchSpec, LM_SHAPES, TransformerConfig

MODEL = TransformerConfig(
    name="minicpm-2b",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,        # MiniCPM ties embeddings
    rope_theta=10000.0,
    activation="silu",
    remat="layer",
    param_dtype="float32",
    compute_dtype="bfloat16",
)

ARCH = ArchSpec(
    arch_id="minicpm-2b",
    family="lm",
    model=MODEL,
    shapes=dict(LM_SHAPES),
    source="arXiv:2404.06395; hf",
    notes="MHA (kv=36); WSD schedule is the training-side feature.",
    skipped_shapes={
        "long_500k": "pure full-attention arch: 512k decode requires "
                     "sub-quadratic attention (see DESIGN.md §Skips)",
    },
)
