"""Config schema (counterpart of ``repro.configs.base``).

The port carries the pieces its slices use: :class:`MoEConfig`,
:class:`TransformerConfig`, :class:`GNNConfig`, :class:`RecsysConfig`,
:class:`ShapeSpec`, :class:`ArchSpec`, :data:`LM_SHAPES`,
:data:`GNN_SHAPES`, :data:`RECSYS_SHAPES` and :data:`JEDI_SHAPES`, field
for field as the reference declares them.

Two port-only subclasses carry DeepSeek-V3's architecture, which the
reference has no counterpart of: :class:`MLAConfig` (multi-head latent
attention and leading dense layers) and :class:`RoutedMoEConfig` (shared
experts, sigmoid scoring with a correction bias, dropless routing).  They
are subclasses so that the mirrored classes keep the reference's fields
exactly.
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
class RoutedMoEConfig(MoEConfig):
    """DeepSeek-V3's MoE (``modeling_deepseek.py``'s ``MoEGate`` with
    ``topk_method="noaux_tc"``, one group): sigmoid scores in fp32, the top
    ``top_k`` chosen by score + a per-expert correction bias, the chosen
    scores (without the bias) normalised when ``norm_topk_prob`` and
    scaled by ``routed_scaling_factor``; ``n_shared_experts`` SwiGLU
    experts of the routed width run on every token as one of
    ``n_shared_experts`` times that width.  Dropless: every assignment is
    computed (``capacity_factor`` is unused)."""
    n_shared_experts: int = 0
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0


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
class MLAConfig(TransformerConfig):
    """DeepSeek-V3's decoder: multi-head latent attention without q-LoRA
    (q from one product; k and v from a ``kv_lora_rank`` latent that is
    RMS-normed, plus one ``qk_rope_head_dim`` rope key shared by the heads)
    and ``first_k_dense`` leading dense layers of width ``dense_d_ff``
    before the MoE layers (whose expert width is ``d_ff``).  The decode
    cache holds the latent and the rope key, not k and v."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense: int = 0
    dense_d_ff: int = 0
    norm_eps: float = 1e-6

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                    # gcn | pna | meshgraphnet | equiformer_v2 | jedinet
    n_layers: int
    d_hidden: int
    n_classes: int = 16
    aggregators: tuple = ("mean",)
    scalers: tuple = ("identity",)
    mlp_layers: int = 2          # meshgraphnet per-MLP depth
    l_max: int = 0               # equiformer
    m_max: int = 0
    n_heads: int = 1
    norm: str = "layernorm"
    activation: str = "relu"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"   # GNNs here are small; fp32 keeps eSCN stable
    remat: str = "none"
    # kept for parity with the reference's scan switch (Python loops here)
    unroll_scans: bool = False
    edge_chunk: int = 1 << 20        # equiformer eSCN conv edge-chunk size


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
    kind: str        # train | prefill | decode | full_graph | minibatch |
    #                  batched_graphs | recsys_train | recsys_serve |
    #                  retrieval | jedi_infer | jedi_train
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

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "full_graph",
                               dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    "minibatch_lg": ShapeSpec("minibatch_lg", "minibatch",
                              dict(n_nodes=232965, n_edges=114615892,
                                   batch_nodes=1024, fanout=(15, 10),
                                   d_feat=602)),
    "ogb_products": ShapeSpec("ogb_products", "full_graph",
                              dict(n_nodes=2449029, n_edges=61859140,
                                   d_feat=100)),
    "molecule": ShapeSpec("molecule", "batched_graphs",
                          dict(n_nodes=30, n_edges=64, batch=128, d_feat=16)),
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
    family: str                  # lm | gnn | recsys | jedi
    model: Any                   # TransformerConfig | GNNConfig | RecsysConfig | JediNetConfig
    shapes: dict                 # name -> ShapeSpec
    source: str = ""             # citation tag
    notes: str = ""
    # cells intentionally not run for this arch, mapped to the reason
    skipped_shapes: dict = dataclasses.field(default_factory=dict)

    def runnable_shapes(self):
        return {k: v for k, v in self.shapes.items()
                if k not in self.skipped_shapes}
