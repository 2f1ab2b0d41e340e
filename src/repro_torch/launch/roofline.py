"""Roofline terms of one step, counted on the ops one rank runs.

Port of ``repro.launch.roofline``.  The reference reads a compiled XLA
executable (``cost_analysis()``, the optimized HLO's collectives,
``memory_analysis()``) and divides by a TPU v5e's peaks.  Here one step
runs eagerly, on real tensors or under ``FakeTensorMode`` (the dry run,
``launch/dryrun.py``), inside :class:`StepCounter`, a
``TorchDispatchMode`` that counts every op rank 0 runs, and the peaks are
one NVIDIA H100 SXM5's (``core/codesign.py``, NVIDIA's datasheet):

    compute    = sum over dtypes of FLOPs_dtype / peak_dtype
                 (fp32 at H100_FP32_FLOPS = 67e12 on the CUDA cores: TF32
                 stays off, as the reference's fp32 products; bf16 and
                 fp16 at H100_BF16_FLOPS = 989e12 on the tensor cores,
                 dense; any other dtype at the fp32 peak)
    memory     = bytes / H100_HBM_BPS (3.35e12)
    collective = sum over collectives of bytes / the link's rate

* **FLOPs** come from ``torch.utils.flop_counter``'s formulas (the
  registry ``FlopCounterMode`` reads: matrix products, convolutions,
  attention, and kernel B5's ``repro_torch::flash_decode``), split by
  the dtype of the op's operands (B5's by its cache's dtype, which its
  products run in).
* **Bytes** are each op's tensor inputs read once and its outputs
  written once (an in-place op writes the tensors it mutates), with no
  fusion: an eager step does move them.  A view moves nothing.  A gather
  (``index``, ``index_select``, ``embedding``, ``gather``) reads only
  the rows it takes, so its source counts as its output's bytes; an
  in-place scatter (``index_put_``, ``index_add_``, ``index_copy_``,
  ``scatter_*_``) reads and writes only the rows it touches, so its
  destination counts as its source's bytes.
* **Collectives** are the functional collectives DTensor issues
  (``_c10d_functional``'s ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``),
  each counted by its output's bytes under the reference's op names.  A
  collective runs over one mesh dimension's group.  The group lies in
  one 8-GPU node when its size times its stride in the mesh (ranks laid
  row-major) is at most 8: it is billed at NVLink 4's rate, else at the
  per-GPU network rate.  On the production meshes every axis (16 or 2
  ranks, strides 1, 16 and 256) crosses nodes.  A group of one rank
  moves nothing.
* **Memory** tracks the storages the step's tensors live in (rank 0's
  local shards; weak references, so the counter keeps nothing alive):
  ``argument_bytes`` are the step's inputs, ``output_bytes`` the
  storages of its outputs that are not inputs, ``peak_bytes`` the most
  bytes live at once (inputs included) and ``temp_bytes`` = peak -
  arguments - outputs.  Workspaces a library takes outside the
  dispatcher (cuBLAS, cub) are not seen.

**Per rank.**  Inside a ``DTensor`` step the counter declines every op
on ``DTensor``s (it returns ``NotImplemented``), so DTensor runs it and
the counter sees the local ops on rank 0's shards, the collectives
included: the reference's numbers are per device too.  Ops on fake
tensors DTensor runs to learn an output's global shape (its sharding
propagation) are not counted.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core.codesign import H100_BF16_FLOPS, H100_FP32_FLOPS, \
    H100_HBM_BPS, H100_NVLINK_BPS
from repro_torch.kernels.flash_decode import kernel as FDK

#: Compute peak by dtype (NVIDIA H100 SXM5 datasheet, dense).
PEAK_FLOPS = {torch.float32: H100_FP32_FLOPS,
              torch.bfloat16: H100_BF16_FLOPS,
              torch.float16: H100_BF16_FLOPS}
#: GPUs of one node that NVLink joins (DGX / HGX H100).
NODE_GPUS = 8
#: NVLink 4 inside a node: H100_NVLINK_BPS (900e9) counts both
#: directions; a collective's output arrives at half of it.
NVLINK_BPS = H100_NVLINK_BPS / 2
#: Between nodes: one 400 Gb/s NDR InfiniBand port (ConnectX-7) per GPU,
#: one direction (NVIDIA DGX H100 datasheet).
NETWORK_BPS = 400e9 / 8

#: The reference's collective names (XLA's opcodes).
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_GATHERS = {"index", "index_select", "embedding", "gather"}
_SCATTERS = {"index_put_", "index_add_", "index_copy_", "scatter_",
             "scatter_add_", "scatter_reduce_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _flop_dtype(func, args) -> torch.dtype:
    """The dtype an op's products run in: B5's cache's, else its first
    floating operand's."""
    if func._overloadpacket is FDK.flash_decode_op:
        return args[1].dtype
    for t in _tensors(args):
        if t.is_floating_point():
            return t.dtype
    return torch.float32


class StepCounter(TorchDispatchMode):
    """Counts FLOPs by dtype, bytes, collectives and live storage of the
    ops run inside it (see the module docstring).  ``fake_mode``: the
    ``FakeTensorMode`` the step's fake tensors belong to (None for real
    tensors); ``mesh``: the ``DeviceMesh`` whose groups the collectives
    run over."""

    def __init__(self, fake_mode=None, mesh=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = collections.Counter()
        self.hbm_bytes = 0
        self.coll_bytes = collections.Counter()
        self.coll_count = collections.Counter()
        self.coll_s = 0.0
        self.coll_bytes_by_link = collections.Counter()
        self.live = self.peak = self.argument_bytes = 0
        self._tracked: dict = {}
        self._links = _group_links(mesh)
        self._paused = 0

    # -- memory ---------------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._tracked:
            return
        n = st.nbytes()
        self._tracked[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._tracked.pop(key, 0)

    def track_args(self, args) -> None:
        """Register the step's inputs (local shards of DTensors)."""
        for t in _tensors(_locals(args)):
            self._track(t)
        self.argument_bytes = self.live

    def memory(self, out, args) -> dict:
        """``argument_bytes``, ``output_bytes``, ``temp_bytes`` and
        ``peak_bytes`` of the step that returned ``out`` from ``args``."""
        seen = {t.untyped_storage()._cdata for t in _tensors(_locals(args))}
        outs = {}
        for t in _tensors(_locals(out)):
            st = t.untyped_storage()
            if st._cdata not in seen:
                outs[st._cdata] = st.nbytes()
        output = sum(outs.values())
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": output,
                "temp_bytes": max(self.peak - self.argument_bytes - output,
                                  0),
                "peak_bytes": self.peak}

    # -- dispatch -------------------------------------------------------------

    def _foreign(self, tensors) -> bool:
        return any(isinstance(t, FakeTensor) and t.fake_mode is not
                   self.fake_mode for t in tensors)

    def __enter__(self):
        # DTensor runs each new op once on fake tensors of its GLOBAL
        # shapes to learn its output's shape, in the step's own fake mode
        # if there is one: those ops are paused, not counted
        prop = ShardingPropagator._propagate_tensor_meta_non_cached
        self._prop = prop
        counter = self

        def paused(*a, **kw):
            counter._paused += 1
            try:
                return prop(*a, **kw)
            finally:
                counter._paused -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._propagate_tensor_meta_non_cached = self._prop
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs the local ops
        out = func(*args, **kwargs)
        if self._paused:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self._foreign(ins + outs):
            return out
        for t in outs:
            self._track(t)
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            self._collective(name, outs, args)
            return out
        if packet in flop_registry:
            self.flops[_flop_dtype(func, args)] += int(
                flop_registry[packet](*args, **kwargs, out_val=out))
        self.hbm_bytes += self._op_bytes(func, name, args, ins, outs)
        return out

    def _op_bytes(self, func, name, args, ins, outs) -> int:
        schema = func._schema
        if not schema.is_mutable:
            # a view, an alias (``_unsafe_view``, ``detach``), an
            # allocation (``empty*``) or a query (``prim.device``) moves
            # nothing
            if not outs or name.startswith(("empty", "new_empty")):
                return 0
            held = {t.untyped_storage()._cdata for t in ins}
            if func.is_view or all(t.untyped_storage()._cdata in held
                                   for t in outs):
                return 0
        written = list(outs)
        if schema.is_mutable:
            for a, val in zip(schema.arguments, args):
                if a.alias_info is not None and a.alias_info.is_write:
                    written += _tensors(val)
            # outputs of an in-place op are the mutated inputs
            uniq = {id(t): t for t in written}
            written = list(uniq.values())
        if name in _GATHERS:
            src = args[0]
            got = sum(_nbytes(t) for t in outs)
            return got + sum(_nbytes(t) for t in ins if t is not src) + got
        if name in _SCATTERS:
            dst = args[0]
            srcs = [t for t in ins if t is not dst]
            touched = max((_nbytes(t) for t in srcs), default=0)
            return sum(_nbytes(t) for t in srcs) + 2 * touched
        read = {id(t): t for t in ins}
        return sum(_nbytes(t) for t in read.values()) + sum(
            _nbytes(t) for t in written)

    def _collective(self, name, outs, args) -> None:
        op = _COLLECTIVES.get(name)
        if op is None:                     # wait_tensor and the like
            return
        group = next((a for a in args if isinstance(a, str)), None)
        size, link = self._links.get(group, (None, "network"))
        nbytes = 0 if size == 1 else sum(_nbytes(t) for t in outs)
        self.coll_bytes[op] += nbytes
        self.coll_count[op] += 1
        self.coll_bytes_by_link[link] += nbytes
        self.coll_s += nbytes / (NVLINK_BPS if link == "nvlink"
                                 else NETWORK_BPS)

    # -- results --------------------------------------------------------------

    def collectives(self) -> dict:
        per_op = {k: int(self.coll_bytes[k]) for k in COLLECTIVE_OPS}
        count = {k: int(self.coll_count[k]) for k in COLLECTIVE_OPS}
        return {"bytes_by_op": per_op, "counts_by_op": count,
                "total_bytes": sum(per_op.values()),
                "total_count": sum(count.values()),
                "bytes_by_link": {k: int(self.coll_bytes_by_link[k])
                                  for k in ("nvlink", "network")}}

    def terms(self, chips: int) -> "RooflineTerms":
        return RooflineTerms(
            flops_by_dtype={str(k).removeprefix("torch."): int(v)
                            for k, v in self.flops.items()},
            hbm_bytes=float(self.hbm_bytes),
            coll_bytes=float(sum(self.coll_bytes.values())),
            coll_s=self.coll_s, chips=chips)


def _locals(tree):
    """DTensor leaves as their local shards."""
    flat, _ = tree_flatten(tree)
    return [t.to_local() if isinstance(t, DTensor) else t for t in flat]


def _group_links(mesh) -> dict:
    """``{group name: (ranks, "nvlink" | "network")}`` of each mesh dim."""
    if mesh is None:
        return {}
    shape = tuple(mesh.shape)
    links = {}
    for dim, size in enumerate(shape):
        stride = 1
        for s in shape[dim + 1:]:
            stride *= s
        link = "nvlink" if size * stride <= NODE_GPUS else "network"
        links[mesh.get_group(dim).group_name] = (size, link)
    return links


def _peak(dtype_name: str) -> float:
    return PEAK_FLOPS.get(getattr(torch, dtype_name, None), H100_FP32_FLOPS)


@dataclasses.dataclass
class RooflineTerms:
    flops_by_dtype: dict         # per device, by dtype name
    hbm_bytes: float             # per device
    coll_bytes: float            # per device
    coll_s: float                # per device, each collective at its link
    chips: int

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def compute_s(self) -> float:
        return sum(f / _peak(d) for d, f in self.flops_by_dtype.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / H100_HBM_BPS

    @property
    def collective_s(self) -> float:
        return self.coll_s

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """No-overlap upper bound on the step time."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "step_s": self.step_s,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "rates": RATES,
        }


#: The rates every record is billed at, named.
RATES = {
    "device": "NVIDIA H100 SXM5 (datasheet)",
    "fp32_flops": H100_FP32_FLOPS, "bf16_flops": H100_BF16_FLOPS,
    "hbm_Bps": H100_HBM_BPS,
    "nvlink_Bps": NVLINK_BPS,
    "nvlink_note": "NVLink 4, 900e9 B/s both directions, one direction "
                   "billed; groups inside one 8-GPU node",
    "network_Bps": NETWORK_BPS,
    "network_note": "400 Gb/s NDR InfiniBand per GPU, one direction; "
                    "groups that span nodes",
}


def record(counter: StepCounter, chips: int, out, args) -> dict:
    """The reference's record keys: ``roofline``, ``collectives`` and
    ``memory``, from one counted step."""
    return {"roofline": counter.terms(chips).to_dict(),
            "collectives": counter.collectives(),
            "memory": counter.memory(out, args)}


def model_flops_lm(cfg, n_tokens: int, train: bool = True) -> float:
    """MODEL_FLOPS = 6*N_active*D for train, 2*N*D for inference."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.common.tree import tree_leaves
    from repro_torch.models import transformer as tfm

    with FakeTensorMode(allow_non_fake_inputs=True):
        a_params = tfm.init(0, cfg, device="cpu")
    total = sum(int(np_prod(t.shape)) for t in tree_leaves(a_params))
    if cfg.moe is not None:
        # active experts per token = top_k of n_experts (+ dense residual)
        moe = cfg.moe
        expert_p = 3 * cfg.d_model * cfg.d_ff
        per_layer_moe = moe.n_experts * expert_p
        active_moe = moe.top_k * expert_p
        total_active = total - cfg.n_layers * (per_layer_moe - active_moe)
    else:
        total_active = total
    return (6.0 if train else 2.0) * total_active * n_tokens


def np_prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out
