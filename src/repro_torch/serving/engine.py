"""Trigger inference engine over the JEDI-net forward paths, data-parallel.

Port of ``repro.serving.engine``.  The generic machinery (bound-callable
cache, pad-to-bucket dispatch, async in-flight window, watchdog,
wall-union KGPS, fault seams) lives in
:class:`~repro_torch.serving.core.ExecutionCore`; this module adds what
is trigger-specific:

* **PathSpec resolution** — forward fn, params transform (e.g. int8
  quantization), supported compute dtypes, the bucket policy and the
  params binding (split, packed, device-resident kernel weights) are
  read off the path's :class:`~repro_torch.core.paths.PathSpec`;
* **data-parallel shards** — the counterpart of the reference's
  ``shard_map`` of the forward over the batch axis of the local mesh,
  single-controller as it is (one process drives every local device):
  ``shards`` is a list of devices, every local CUDA device by default
  (one on a one-card machine, where nothing is split).  Each bucket gets
  one bound callable per shard; a padded batch is split along axis 0
  into ``n_shards`` equal slices, each slice runs the whole path on its
  shard's device (on that device's current stream), and the outputs are
  gathered onto the first shard's device.  The bucket ladder is the
  path's per-shard ladder scaled by ``n_shards``, and a bucket that does
  not divide the shards is refused.  A list may name one device twice:
  then two shards run on one card, or on the CPU, so that the split and
  the gather can be held on a one-card machine.
"""

from __future__ import annotations

import contextlib
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


def default_shards(device) -> list:
    """Every local CUDA device when ``device`` is an unindexed ``cuda`` on a
    machine with more than one, else ``[device]``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


class TriggerWorkload(Workload):
    """Jet classification over one forward path, data-parallel over
    ``shards``: dense ``(batch, N_o, P)`` event batches through a
    registered PathSpec."""

    def __init__(self, params, cfg, *, forward: str = "fused_full",
                 device="cuda", shards=None):
        self.spec = forward_paths.get(forward)   # raises listing choices
        if not self.spec.supports_dtype(cfg.compute_dtype):
            raise ValueError(
                f"path {forward!r} supports compute dtypes "
                f"{self.spec.compute_dtypes}, not {cfg.compute_dtype!r}")
        self.shards = [resolve_device(d) for d in
                       (default_shards(device) if shards is None else shards)]
        if not self.shards:
            raise ValueError("shards must name at least one device")
        self.n_shards = len(self.shards)
        self.device = self.shards[0]
        # the spec's params transform (e.g. int8 quantization) runs ONCE
        self.params = self.spec.prepare_params(params_to(params, self.device))
        self.cfg = cfg
        self.name = forward

    def bucket_ladder(self, max_batch: int) -> list[int]:
        # ceil, so the top rung still covers max_batch once the per-shard
        # ladder is scaled back up by the shard count
        per_shard = -(-max_batch // self.n_shards)
        ladder = self.spec.bucket_ladder(self.cfg, self.params, per_shard)
        return [b * self.n_shards for b in ladder]

    def validate_buckets(self, bucket_sizes) -> None:
        bad = [b for b in bucket_sizes if b % self.n_shards]
        if bad:
            raise ValueError(f"buckets {bad} do not divide the "
                             f"{self.n_shards} data-parallel shards")

    def cache_key(self, bucket) -> tuple:
        c = self.cfg
        return (self.name, int(bucket), c.n_objects, c.n_features,
                c.compute_dtype, tuple(map(str, self.shards)))

    def build(self, bucket=None):
        fn, cfg, shards = self.spec.forward, self.cfg, self.shards
        bound = [self.spec.bind(params_to(self.params, d), cfg)
                 for d in shards]

        def call(x):
            outs = []
            for dev, b, xs in zip(shards, bound, x.chunk(len(shards))):
                with _on(dev):
                    outs.append(fn(b, cfg, xs.to(dev, non_blocking=True)))
            if len(outs) == 1:
                return outs[0]
            return torch.cat([o.to(self.device, non_blocking=True)
                              for o in outs])
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


def _on(dev: torch.device):
    """The device's context for a CUDA shard (its current stream takes the
    launches); nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


class ServingEngine(ExecutionCore):
    """Bucketed, metered inference over one forward path, data-parallel
    over ``shards`` (see :class:`TriggerWorkload`)."""

    def __init__(self, params, cfg, *, forward: str = "fused_full",
                 device="cuda", shards=None, bucket_sizes=None,
                 max_batch: int = 1024,
                 metrics: ServingMetrics | None = None, injector=None):
        super().__init__(
            TriggerWorkload(params, cfg, forward=forward, device=device,
                            shards=shards),
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

    @property
    def n_shards(self) -> int:
        return self.workload.n_shards

    def roofline(self, buckets=None) -> dict:
        """H100Model step-time context per bucket, at the spec's declared
        fusion level and weight precision, billed at the peak of the
        engine's compute dtype (float32 at the CUDA-core peak, bfloat16
        at the tensor-core peak), over ``n_shards`` chips."""
        return self.spec.roofline_for(
            self.cfg, buckets if buckets is not None else self.bucket_sizes,
            compute_bytes=as_dtype(self.cfg.compute_dtype).itemsize,
            chips=self.n_shards)
