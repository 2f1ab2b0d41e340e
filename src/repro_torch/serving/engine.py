"""Trigger inference engine over the JEDI-net forward paths, on one GPU.

Port of ``repro.serving.engine``.  The generic machinery (bound-callable
cache, pad-to-bucket dispatch, async in-flight window, watchdog,
wall-union KGPS, fault seams) lives in
:class:`~repro_torch.serving.core.ExecutionCore`; this module adds what
is trigger-specific:

* **PathSpec resolution** — forward fn, params transform (e.g. int8
  quantization), supported compute dtypes, the bucket policy and the
  params binding (split, packed, device-resident kernel weights) are
  read off the path's :class:`~repro_torch.core.paths.PathSpec`;
* **one device** — the reference's data-parallel mesh and ``shard_map``
  are dropped: a workload runs on one ``device``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import paths as forward_paths
from repro_torch.nn.core import as_dtype
from repro_torch.serving import faults
from repro_torch.serving.core import (  # noqa: F401  (re-exported)
    MAX_INFLIGHT_CHUNKS,
    DeviceResult,
    ExecutionCore,
    PendingResult,
    WatchdogTimeout,
    Workload,
    serve_stream,
)
from repro_torch.serving.metrics import ServingMetrics


def params_to(params, device: torch.device):
    """A params pytree with every tensor leaf moved to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    if isinstance(params, torch.Tensor):
        return params.to(device)
    return params


class TriggerWorkload(Workload):
    """Jet classification over one forward path on one device: dense
    ``(batch, N_o, P)`` event batches through a registered PathSpec."""

    def __init__(self, params, cfg, *, forward: str = "fused_full",
                 device="cuda"):
        self.spec = forward_paths.get(forward)   # raises listing choices
        if not self.spec.supports_dtype(cfg.compute_dtype):
            raise ValueError(
                f"path {forward!r} supports compute dtypes "
                f"{self.spec.compute_dtypes}, not {cfg.compute_dtype!r}")
        self.device = resolve_device(device)
        # the spec's params transform (e.g. int8 quantization) runs ONCE
        self.params = self.spec.prepare_params(params_to(params, self.device))
        self.cfg = cfg
        self.name = forward

    def bucket_ladder(self, max_batch: int) -> list[int]:
        return self.spec.bucket_ladder(self.cfg, self.params, max_batch)

    def cache_key(self, bucket) -> tuple:
        c = self.cfg
        return (self.name, int(bucket), c.n_objects, c.n_features,
                c.compute_dtype, str(self.device))

    def build(self, bucket=None):
        bound = self.spec.bind(self.params, self.cfg)
        fn, cfg = self.spec.forward, self.cfg

        def call(x):
            return fn(bound, cfg, x)
        return call

    def placeholder(self, bucket: int) -> np.ndarray:
        c = self.cfg
        return np.zeros((bucket, c.n_objects, c.n_features), np.float32)

    def corrupted(self, seam: str, factor: float, bucket):
        # Silent fault seams: rebuild the bucket's callable from corrupted
        # params; None means "does not apply" and the fault keeps its budget.
        if seam == "scale_drift":
            bad = faults.drift_scales(self.params, factor)
        elif seam == "weight_corrupt":
            bad = faults.corrupt_weight(self.params, factor)
        else:
            return None
        if bad is self.params:
            return None
        twin = copy.copy(self)
        twin.params = bad
        return twin.build(bucket)


class ServingEngine(ExecutionCore):
    """Bucketed, metered inference over one forward path on one device."""

    def __init__(self, params, cfg, *, forward: str = "fused_full",
                 device="cuda", bucket_sizes=None, max_batch: int = 1024,
                 metrics: ServingMetrics | None = None, injector=None):
        super().__init__(
            TriggerWorkload(params, cfg, forward=forward, device=device),
            bucket_sizes=bucket_sizes, max_batch=max_batch,
            metrics=metrics, injector=injector)

    @property
    def spec(self):
        return self.workload.spec

    @property
    def params(self):
        return self.workload.params

    @property
    def cfg(self):
        return self.workload.cfg

    @property
    def forward(self) -> str:
        return self.workload.name

    def roofline(self, buckets=None) -> dict:
        """H100Model step-time context per bucket, at the spec's declared
        fusion level and weight precision, billed at the peak of the
        engine's compute dtype (float32 at the CUDA-core peak, bfloat16
        at the tensor-core peak)."""
        return self.spec.roofline_for(
            self.cfg, buckets if buckets is not None else self.bucket_sizes,
            compute_bytes=as_dtype(self.cfg.compute_dtype).itemsize)
