"""Config schema (counterpart of ``repro.configs.base``).

The port carries the pieces its slices use: :class:`MoEConfig`,
:class:`TransformerConfig`, :class:`RecsysConfig`, :class:`ShapeSpec`,
:class:`ArchSpec`, :data:`LM_SHAPES`, :data:`RECSYS_SHAPES` and
:data:`JEDI_SHAPES`, field for field as the reference declares them.
The GNN configs come with their slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Arctic-style dense residual FFN running in parallel with the experts.
    dense_residual: bool = False
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None         # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    sliding_window: Optional[int] = None   # SWA (h2o-danube)
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    activation: str = "silu"               # SwiGLU by default
    tie_embeddings: bool = False
    # per-layer rematerialisation in training: "layer" recomputes each
    # layer's activations in the backward (torch.utils.checkpoint)
    remat: str = "layer"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # the reference's switch to unroll its lax.scans; the port's loops
    # are Python loops, so the field is kept for parity only
    unroll_scans: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_full_attention(self) -> bool:
        return self.sliding_window is None


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str = "fm"
    n_sparse: int = 39
    embed_dim: int = 10
    # Criteo-like skewed table sizes; the total is what matters for sharding.
    vocab_sizes: tuple = ()
    dense_dim: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def total_rows(self) -> int:
        return int(sum(self.vocab_sizes))


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode | recsys_train |
    #                  recsys_serve | retrieval | jedi_infer | jedi_train
    dims: dict

    def dim(self, k: str, default=None):
        return self.dims.get(k, default)


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            dict(seq_len=32768, global_batch=128)),
    "long_500k": ShapeSpec("long_500k", "decode",
                           dict(seq_len=524288, global_batch=1)),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "recsys_train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "recsys_serve", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "recsys_serve", dict(batch=262144)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1000000)),
}

JEDI_SHAPES = {
    "stream_1k": ShapeSpec("stream_1k", "jedi_infer", dict(batch=1000)),
    "train_jets": ShapeSpec("train_jets", "jedi_train", dict(batch=4096)),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                  # lm | recsys | jedi
    model: Any                   # TransformerConfig | RecsysConfig | JediNetConfig
    shapes: dict                 # name -> ShapeSpec
    source: str = ""             # citation tag
    notes: str = ""
    # cells intentionally not run for this arch, mapped to the reason
    skipped_shapes: dict = dataclasses.field(default_factory=dict)

    def runnable_shapes(self):
        return {k: v for k, v in self.shapes.items()
                if k not in self.skipped_shapes}
