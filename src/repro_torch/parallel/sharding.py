"""Logical-axis sharding: one rules table maps model axes to mesh axes.

Port of ``repro.parallel.sharding`` onto ``torch.distributed``'s
``DeviceMesh`` and ``DTensor``.  Model code annotates activations with
*logical* axis names (``constrain(h, "batch", "seq", None)``); the
launcher installs an ``axis_rules`` context binding those names to the
axes of the active mesh (single-pod ``(data, model)`` or multi-pod
``(pod, data, model)``).  Outside a context every annotation is a no-op,
so unit tests and single-card runs use the exact same model code
unsharded.

Parameter sharding is path-regex based (``PARAM_RULES``, the reference's
table verbatim): weights are sharded over both mesh axes where possible
(tensor-parallel over ``model`` and FSDP over ``data``).

What stands where the reference has JAX's types:

* :class:`PartitionSpec` is a tuple of entries (a mesh axis name, a
  tuple of names, or ``None`` per tensor dimension); ``tuple(spec)`` and
  equality behave as JAX's ``P``.
* :class:`NamedSharding` is ``(mesh, spec)``, with ``placements`` for
  ``DTensor``: ``Shard(d)`` on every mesh dimension that tensor
  dimension ``d`` names, ``Replicate()`` elsewhere.  A dimension sharded
  over several mesh axes is split by ``DTensor`` in mesh-dimension
  order, as JAX splits it in the entry's order, so an entry must name
  its axes in mesh order (``placements`` raises otherwise).
* The spec logic reads only the mesh's axis names and sizes
  (:func:`mesh_axes`), so a duck-typed mesh with ``axis_names`` and a
  ``shape`` dict serves as well as a ``DeviceMesh``.
* ``constrain`` inside a context ``redistribute``s a ``DTensor`` to the
  spec's placements (the counterpart of ``with_sharding_constraint``);
  a plain tensor is returned unchanged.  The context also lets a plain
  tensor meet a ``DTensor`` as if replicated on the mesh (positions,
  masks, index tables: the constants XLA's partitioner replicates).

The reference's ``shard_map_compat`` has no counterpart: the port's
manual collectives (``parallel/moe_dispatch.py``,
``training/grad_compression.py``) run on a process group in every rank's
own program, which is what ``shard_map`` emulates.

Non-divisible cases (e.g. 56 heads over a 16-way ``model``) are allowed
in ``constrain`` (``DTensor`` shards unevenly); ``param_shardings`` and
the other state shardings trim to a dividing prefix (``divisible_spec``),
as the reference does for ``jit``'s in_shardings.

Redistribution seams stand where XLA's partitioner would reshard and
DTensor (torch 2.11, 2.13, or both) refuses or miscounts:
``flatten_ready`` (a product's flattened leading axes), ``split_reshape``
(a view that splits heads or tokens off a sharded dim), ``rows_reshape``
(a view of edge / node rows), ``replicated`` and ``on_whole`` (an op
without a DTensor rule, run on whole values).  Each also readies the
grad for the view's backward where a view is involved.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.common.tree import path_map, tree_map

_CTX = threading.local()

#: The mesh axes in mesh order: every multi-axis rule names its axes in
#: this order (checked below), since DTensor splits a dimension sharded
#: over several mesh dimensions in mesh-dimension order.
MESH_AXES = ("pod", "data", "model")

# Logical axis -> tuple of mesh axes that shard it (filtered by mesh).
DEFAULT_RULES = {
    # activations
    "batch": ("pod", "data"),
    "seq": ("model",),                # sequence-parallel residual stream
    "tokens": ("pod", "data", "model"),  # flattened (batch*seq) token axis
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "qlen": (),
    "kvlen": ("model",),       # seq-sharded KV cache when kv_heads < model
    "head_dim": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "classes": (),
    # MoE
    "expert": ("data",),
    # NB: sharding expert_slot over `model` was tried in §Perf cell B and
    # measured neutral (227 vs 231 GB/device collectives) — the dispatch
    # scatter still all-gathers its payload; see EXPERIMENTS.md §Perf.
    "expert_slot": (),
    # graphs: node/edge sets are sharded over the full chip set
    "nodes": ("pod", "data", "model"),
    "edges": ("pod", "data", "model"),
    "graph_feat": (),
    # recsys
    "table_rows": ("pod", "data", "model"),
    "candidates": ("pod", "data", "model"),
    # weights
    "fsdp": ("data",),
    "w_model": ("model",),
    "replicated": (),
    # pipeline stage axis (only bound when PP over pods is enabled)
    "stage": ("pod",),
}


def _in_mesh_order(axes) -> bool:
    idx = [MESH_AXES.index(a) for a in axes]
    return idx == sorted(idx)


for _name, _axes in DEFAULT_RULES.items():
    if not _in_mesh_order(_axes):
        raise AssertionError(f"rule {_name!r}: {_axes} not in mesh order "
                             f"{MESH_AXES}")


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor: an axis name, a tuple of
    names, or ``None`` (unsharded); JAX's ``P`` as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names`` and
    the ``shape`` tuple) or of a duck-typed mesh (``axis_names`` and a
    ``shape`` dict)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """The ``DTensor`` placements, one per mesh dimension."""
        names = list(mesh_axes(self.mesh))
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(
                    f"dimension {d} of {self.spec} names mesh axes {axes} "
                    f"out of the mesh's order {tuple(names)}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[dict] = None):
    """Install a (mesh, logical-rules) context for ``constrain``; inside
    it a plain tensor that meets a ``DTensor`` is taken as replicated."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = (mesh, dict(DEFAULT_RULES, **(rules or {})))
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.state = prev


def current_mesh():
    st = getattr(_CTX, "state", None)
    return st[0] if st else None


def _filter_axes(axes, mesh):
    """Keep only axes present in the mesh (e.g. drop 'pod' on single-pod)."""
    names = mesh_axes(mesh)
    present = tuple(a for a in axes if a in names)
    if len(present) == 0:
        return None
    if len(present) == 1:
        return present[0]
    return present


def logical_to_spec(logical_axes, mesh, rules: dict) -> PartitionSpec:
    """('batch', None, 'embed') -> PartitionSpec for this mesh."""
    spec = []
    for name in logical_axes:
        if name is None:
            spec.append(None)
            continue
        axes = rules.get(name)
        if axes is None:
            raise KeyError(f"unknown logical axis {name!r}")
        spec.append(_filter_axes(axes, mesh))
    return P(*spec)


def constrain(x, *logical_axes):
    """``redistribute`` a DTensor to the logical axes' placements; a
    no-op without a context, and on a plain tensor."""
    st = getattr(_CTX, "state", None)
    if st is None or not isinstance(x, DTensor):
        return x
    mesh, rules = st
    placements = NamedSharding(
        mesh, logical_to_spec(logical_axes, mesh, rules)).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def _whole_inner(x, start: int, end: int):
    """``x`` with dims ``start+1..end`` whole (``Replicate`` on the mesh
    dims that shard them) and dim ``start`` evenly sharded (over the mesh
    dims whose running product divides it: DTensor's view of an uneven
    shard computes the wrong local shape)."""
    inner = range(start + 1, end + 1)
    placements = tuple(
        Replicate() if isinstance(p, Shard) and p.dim % x.ndim in inner
        else p for p in x.placements)
    if placements != tuple(x.placements):
        x = x.redistribute(x.device_mesh, placements)
    return _parts_whole(x, start, x.shape[start])


class _WholeInnerGrad(torch.autograd.Function):
    """Identity whose backward makes the incoming grad flatten-ready: a
    grad reaches a product's output in whatever layout its consumer left
    (a pointwise op keeps its output's placements for every input)."""

    @staticmethod
    def forward(ctx, x, start, end):
        ctx.span = (start, end)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole_inner(g, *ctx.span), None, None


def flatten_ready(x, start: int, end: int):
    """``x`` ready for a view that flattens its dims ``start..end``, and
    its grad ready for the same in the backward: a ``DTensor`` sharded on
    any of dims ``start+1..end`` is redistributed so those dims are whole
    (``Replicate`` on their mesh dims); ``start`` may stay sharded where
    its shards are even (128 tokens or 3,840 nodes over 512 ranks are
    not: those mesh dims are made whole too).  A redistribution seam:
    ``DTensor`` before torch 2.13 refuses such a view (2.13 keeps it as a
    strided shard), where XLA's partitioner would all-gather.  A plain
    tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    x = _whole_inner(x, start, end)
    if x.requires_grad:
        x = _WholeInnerGrad.apply(x, start, end)
    return x


def _parts_whole(x, dim: int, parts: int):
    """``x`` with dim ``dim`` sharded only over the mesh dims (in mesh
    order) whose running product of sizes divides ``parts``, and whole
    (``Replicate``, an all-gather) on the others."""
    d = dim % x.ndim
    mesh = x.device_mesh
    cut, prod = [], 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == d:
            if cut or parts % (prod * mesh.size(i)):
                cut.append(i)
            else:
                prod *= mesh.size(i)
    if not cut:
        return x
    return x.redistribute(mesh, tuple(
        Replicate() if i in cut else p for i, p in enumerate(x.placements)))


class _PartsWholeGrad(torch.autograd.Function):
    """Identity whose backward makes the incoming grad's dim whole where
    its shard would cut one of ``parts``."""

    @staticmethod
    def forward(ctx, x, dim, parts):
        ctx.cut = (dim, parts)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _parts_whole(g, *ctx.cut), None, None


def _rows_only(x):
    """``x`` sharded on dim 0 alone, evenly (``_parts_whole``), and whole
    on every other dim; partial sums are left as they are."""
    placements = tuple(Replicate() if isinstance(p, Shard) and p.dim % x.ndim
                       else p for p in x.placements)
    if placements != tuple(x.placements):
        x = x.redistribute(x.device_mesh, placements)
    return _parts_whole(x, 0, x.shape[0])


class _RowsOnlyGrad(torch.autograd.Function):
    """Identity whose backward lays the incoming grad out by rows."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _rows_only(g)


def rows_reshape(x, shape):
    """``x.reshape(shape)`` for a view that keeps dim 0 (the rows: edges,
    nodes) and regroups the others, both ways: a ``DTensor`` is laid out
    by rows (dim 0 evenly sharded, every other dim whole) before the
    view, and the grad of the result likewise before the view's
    backward.  A redistribution seam: DTensor refuses a view that splits
    or merges a sharded dim, or computes the wrong local shape for an
    uneven one (torch 2.11 and 2.13), where XLA's partitioner reshards.
    A plain tensor is only reshaped."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    y = _rows_only(x).reshape(shape)
    if y.requires_grad:
        y = _RowsOnlyGrad.apply(y)
    return y


def split_reshape(x, shape, dim: int, parts: int):
    """``x.reshape(shape)`` for a view that splits dim ``dim`` of ``x``
    into ``parts`` x the rest, or that flattens ``parts`` (dim ``dim`` of
    ``x``) with the dims after it, both ways: a ``DTensor`` that shards
    that dim over mesh dims whose sizes do not divide ``parts`` (8 kv
    heads, or 56 heads, over a 16-way ``model`` axis) has it made whole
    there (``Replicate``, an all-gather) before the view, and the grad
    of the result likewise before the view's backward.  A redistribution
    seam: DTensor refuses a view that would cut a part or flatten an
    uneven shard, where XLA's partitioner reshards.  A plain tensor is
    only reshaped."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    y = _parts_whole(x, dim, parts).reshape(shape)
    if y.requires_grad:
        y = _PartsWholeGrad.apply(y, dim, parts)
    return y


def replicated(x):
    """``x`` whole on every rank: a ``DTensor`` redistributed to
    ``Replicate`` on every mesh dim (an all-gather), a plain tensor as it
    is.  A redistribution seam for an op whose ``DTensor`` rule fails on
    a sharded operand."""
    if not isinstance(x, DTensor):
        return x
    whole = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == whole else x.redistribute(
        x.device_mesh, whole)


def shard_block(n: int, mesh, placements, dim: int) -> tuple:
    """(start, size) of this rank's block of a dim of ``n`` sharded by
    ``placements``: ``torch.chunk``'s split, mesh dim by mesh dim, as
    DTensor lays out its shards."""
    lo, size = 0, n
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            step = -(-size // mesh.size(i))
            lo += coord[i] * step
            size = max(0, min(step, size - coord[i] * step))
    return lo, size


def on_whole(fn, *args):
    """``fn(*args)`` on the whole values of its ``DTensor`` args, on every
    rank: each is gathered (``replicated``) and handed to ``fn`` as its
    local tensor, and the result comes back replicated on the mesh
    (``from_local``; both ways differentiable).  A redistribution seam
    for an op that DTensor has no rule for (``scatter_reduce``), where
    XLA's partitioner would gather too.  Without a ``DTensor`` among the
    args, ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    out = fn(*(replicated(a).to_local() if isinstance(a, DTensor) else a
               for a in args))
    return DTensor.from_local(out, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


# ---------------------------------------------------------------------------
# Parameter sharding rules (path-regex -> logical axes per dimension).
#
# Paths look like "layers/attn/wq/w" (stacked layers carry a leading
# n_layers dim, which is always unsharded: the regex rules below give the
# *trailing* dims and we left-pad with None).
# ---------------------------------------------------------------------------

PARAM_RULES: list[tuple[str, tuple]] = [
    # --- LM ---
    (r".*embed/w$", ("vocab", "fsdp")),
    (r".*lm_head/w$", ("fsdp", "vocab")),
    (r".*(wq|wkv_q)/w$", ("fsdp", "w_model")),
    (r".*wk/w$", ("fsdp", "w_model")),
    (r".*wv/w$", ("fsdp", "w_model")),
    (r".*wo/w$", ("w_model", "fsdp")),
    (r".*(w_gate|w_in)/w$", ("fsdp", "w_model")),
    (r".*w_out/w$", ("w_model", "fsdp")),
    (r".*router/w$", ("fsdp", None)),
    # MoE experts: (E, d, ff) / (E, ff, d)
    (r".*experts/(w_gate|w_in)$", ("expert", None, "w_model")),
    (r".*experts/w_out$", ("expert", "w_model", None)),
    # --- GNN --- weights are small: shard the fan-in over data (FSDP) only.
    (r".*gnn.*/w$", ("fsdp", None)),
    # --- recsys ---
    (r".*tables/rows$", ("table_rows", None)),
    (r".*field_bias/rows$", ("table_rows",)),
]


def _divisible_entry(dim_size: int, entry, mesh):
    """Trim a spec entry (axis | tuple | None) to the longest prefix of mesh
    axes whose product divides dim_size.

    Placed state must divide exactly, where ``constrain`` need not;
    non-dividing dims fall back to fewer axes / replication.
    """
    if entry is None or dim_size is None:
        return entry
    sizes = mesh_axes(mesh)
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    keep = []
    prod = 1
    for a in axes:
        sz = sizes[a]
        if dim_size % (prod * sz) == 0:
            keep.append(a)
            prod *= sz
        else:
            break
    if not keep:
        return None
    return keep[0] if len(keep) == 1 else tuple(keep)


def divisible_spec(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return P(*[_divisible_entry(int(d), e, mesh)
               for d, e in zip(shape, t)])


def _spec_for_path(path: str, ndim: int, mesh, rules: dict,
                   shape=None) -> PartitionSpec:
    for pat, logical in PARAM_RULES:
        if re.match(pat, path):
            pad = ndim - len(logical)
            axes = (None,) * pad + tuple(logical)
            spec = logical_to_spec(axes, mesh, rules)
            if shape is not None:
                spec = divisible_spec(spec, shape, mesh)
            return spec
    return P()  # replicate (norms, biases, small heads)


def param_shardings(params, mesh, rules: Optional[dict] = None):
    """Tree of NamedShardings for a param tree, via PARAM_RULES."""
    rules = dict(DEFAULT_RULES, **(rules or {}))

    def _one(path, leaf):
        shape = tuple(leaf.shape)
        return NamedSharding(
            mesh, _spec_for_path(path, len(shape), mesh, rules, shape))

    return path_map(_one, params)


def _padded_spec(spec: PartitionSpec, ndim: int) -> tuple:
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def train_state_shardings(state, mesh, rules: Optional[dict] = None):
    """Shardings for a full trainer state {params, opt, step}.

    Optimizer moments follow their parameter's sharding; Adafactor's
    factored accumulators drop the reduced axis from the param spec
    (r = mean over last dim -> spec[:-1]; c = mean over second-to-last ->
    spec[:-2] + spec[-1:]), so the big per-expert accumulators stay
    sharded exactly like their weights.
    """
    rules_d = dict(DEFAULT_RULES, **(rules or {}))
    params = state["params"]

    flat_spec: dict = {}

    def _collect(path, leaf):
        shape = tuple(leaf.shape)
        flat_spec[path] = _padded_spec(
            _spec_for_path(path, len(shape), mesh, rules_d, shape),
            len(shape))
        return leaf

    path_map(_collect, params)

    p_sh = path_map(
        lambda p, leaf: NamedSharding(mesh, P(*flat_spec[p])), params)

    def _opt_leaf(path, leaf):
        parts = path.split("/")
        head, rest = parts[0], parts[1:]
        if head in ("m", "v", "mu"):
            key = "/".join(rest)
            spec = flat_spec.get(key)
            return NamedSharding(mesh, P(*spec) if spec else P())
        if head == "acc":
            kind = rest[-1]
            key = "/".join(rest[:-1])
            spec = flat_spec.get(key)
            if spec is None:
                return NamedSharding(mesh, P())
            if kind == "v":
                return NamedSharding(mesh, P(*spec))
            if kind == "r":
                return NamedSharding(mesh, P(*spec[:-1]))
            if kind == "c":
                return NamedSharding(mesh, P(*spec[:-2], spec[-1]))
        return NamedSharding(mesh, P())

    opt_sh = path_map(_opt_leaf, state["opt"])
    return {"params": p_sh, "opt": opt_sh,
            "step": NamedSharding(mesh, P())}


def kv_cache_shardings(cache, mesh, rules: Optional[dict] = None):
    """Shardings for a decode KV cache {k, v, slot_pos, pos}.

    Preferred: shard the kv-head axis over `model` (head parallelism).
    When kv_heads doesn't divide the model axis (GQA with few KV heads,
    e.g. arctic kv=8 on a 16-way model axis), fall back to sharding the
    cache SEQUENCE axis over `model` instead.
    """
    rules_d = dict(DEFAULT_RULES, **(rules or {}))
    sizes = mesh_axes(mesh)
    kshape = tuple(cache["k"].shape)      # (L, B, S, Hkv, D)
    model_sz = 1
    for a in rules_d["kv_heads"]:
        if a in sizes:
            model_sz *= sizes[a]
    heads_divide = kshape[3] % max(model_sz, 1) == 0

    def spec(shape, *axes):
        s = logical_to_spec(axes, mesh, rules_d)
        return NamedSharding(mesh, divisible_spec(s, shape, mesh))

    if heads_divide:
        kv_axes = (None, "batch", None, "kv_heads", None)
    else:
        kv_axes = (None, "batch", "kvlen", None, None)
    return {
        "k": spec(kshape, *kv_axes),
        "v": spec(kshape, *kv_axes),
        "slot_pos": spec(tuple(cache["slot_pos"].shape), "batch", None),
        "pos": spec(tuple(cache["pos"].shape), "batch"),
    }


def batch_shardings(batch, mesh, axes_map: dict,
                    rules: Optional[dict] = None):
    """Shardings for an input batch dict via a {key: logical axes} map.

    Divisibility-aware: dims that don't divide their mesh axes keep only a
    dividing prefix (or replicate).
    """
    rules_d = dict(DEFAULT_RULES, **(rules or {}))
    out = {}
    for k, leaf in batch.items():
        axes = axes_map.get(k)
        if axes is None:
            out[k] = NamedSharding(mesh, P())
        else:
            spec = logical_to_spec(axes, mesh, rules_d)
            out[k] = NamedSharding(
                mesh, divisible_spec(spec, tuple(leaf.shape), mesh))
    return out


def distribute(tree, shardings):
    """Each tensor leaf of ``tree`` as a ``DTensor`` on its sharding's mesh
    and placements (``distribute_tensor``: rank 0's values, scattered or
    broadcast, so every rank holds the same global tensor); a ``None``
    sharding leaves the leaf as it is.  The counterpart of
    ``jax.device_put`` with a shardings tree."""
    return tree_map(
        lambda t, s: t if s is None else distribute_tensor(
            t, s.mesh, s.placements), tree, shardings)
