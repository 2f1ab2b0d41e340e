"""Config schema of the recsys family (counterpart of ``repro.configs.base``).

The port carries the pieces its slices use: :class:`RecsysConfig`,
:class:`ShapeSpec`, :class:`ArchSpec` and :data:`RECSYS_SHAPES`, field
for field as the reference declares them.  The LM and GNN configs come
with their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any


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
    kind: str        # recsys_train | recsys_serve | retrieval (this slice)
    dims: dict

    def dim(self, k: str, default=None):
        return self.dims.get(k, default)


RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "recsys_train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "recsys_serve", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "recsys_serve", dict(batch=262144)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1000000)),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                  # recsys (this slice)
    model: Any                   # RecsysConfig
    shapes: dict                 # name -> ShapeSpec
    source: str = ""             # citation tag
    notes: str = ""
    # cells intentionally not run for this arch, mapped to the reason
    skipped_shapes: dict = dataclasses.field(default_factory=dict)

    def runnable_shapes(self):
        return {k: v for k, v in self.shapes.items()
                if k not in self.skipped_shapes}
