"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA.
[arXiv:2401.16818; hf]

The SWA rolling KV cache makes this the one assigned LM arch that runs the
long_500k cell: decode at 512k context touches only the 4096-token window.
The port serves it at full width on one H100 (``serving/lm.py``), its
decode attention on kernel B5.
"""

from repro_torch.configs.base import ArchSpec, LM_SHAPES, TransformerConfig

MODEL = TransformerConfig(
    name="h2o-danube-1.8b",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10000.0,
    activation="silu",
    remat="layer",
    param_dtype="float32",
    compute_dtype="bfloat16",
)

ARCH = ArchSpec(
    arch_id="h2o-danube-1.8b",
    family="lm",
    model=MODEL,
    shapes=dict(LM_SHAPES),
    source="arXiv:2401.16818; hf",
    notes="Sliding-window attention (W=4096) -> sub-quadratic long decode.",
)
