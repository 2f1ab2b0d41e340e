"""Message-passing primitives: edge-index gather + segment reductions.

Port of ``repro.models.gnn.segment_ops``.  The reference builds message
passing from ``jnp.take`` + ``jax.ops.segment_*`` over an edge-index
list; here the same functions are torch's ``index_select``,
``index_add`` and ``scatter_reduce``:

* ``gather(x, idx)``                  — edge <- node gather
* ``scatter_{sum,mean,max,min,std}``  — node <- edge segment reductions
* ``add_at``                          — a segment sum into a running buffer
* ``segment_softmax``                 — edge-softmax over incoming edges
  (GAT/Equiformer attention)
* ``degrees``                         — in/out degree via segment_sum

Index tensors may be int32 (the generators' dtype) or int64.  Nothing
here reads a value back to the host, so a step on the card never waits
on it.

Semantics kept from the reference:

* an empty segment's max (and min) is 0, not -inf: ``scatter_reduce``
  runs on a -inf buffer, as ``jax.ops.segment_max`` starts, and the
  non-finite results map to 0 as the reference maps them;
* a max's (and min's) gradient is split evenly among tied messages, as
  JAX splits it (``[0.5, 0.5, 0, 1]`` for values ``[1, 1, 0.5 | 2]``).
  torch's backward counts the buffer's own entry among the ties even
  with ``include_self=False``: on a zero buffer, a segment of ReLU
  messages that are all 0 would split its gradient three ways between
  two messages.  The -inf buffer never ties with a finite max.

Inside a sharded step (``DTensor`` node features, messages or ids) the
gather and the sum run as XLA's partitioner runs them, on each rank's
local shards: a gather takes the source whole and the rows of the rank's
own ids, a sum adds the rank's own messages into a whole buffer of
partial sums (DTensor's own rules fail: torch 2.11 refuses a gather
whose source and ids shard dim 0 over the same mesh dims, and its
``index_add`` rule pairs sharded messages with whole ids); the max and
min run on the whole messages (``parallel.sharding.on_whole``: DTensor
has no rule for ``scatter_reduce``).

One departure: ids outside ``[0, n)``.  ``jax.ops.segment_sum`` drops a
segment id out of range and ``jnp.take`` fills an out-of-range row with
NaN; torch raises on the CPU and faults on the card.  Checking would
cost a read back to the host per call, and no generator or sampler of
the repo makes such ids (the reference's chunked equiformer path sends
its padding to segment n of n + 1; the port's takes no padding), so the
port does not check.

For the fully-connected receiver-major JEDI-net graph these segment ops
collapse to reshapes (``core/adjacency.py``); the general substrate below
is what the four GNN architectures use.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.parallel.sharding import on_whole, replicated


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (N, ...), idx: (E,) -> (E, ...)."""
    if isinstance(x, DTensor) or isinstance(idx, DTensor):
        return _gather_sharded(x, idx)
    return x.index_select(0, idx)


def scatter_sum(msgs: torch.Tensor, seg_ids: torch.Tensor,
                n: int) -> torch.Tensor:
    if isinstance(msgs, DTensor) or isinstance(seg_ids, DTensor):
        return _scatter_sum_sharded(msgs, seg_ids, n)
    return msgs.new_zeros((n, *msgs.shape[1:])).index_add(0, seg_ids, msgs)


def add_at(buf: torch.Tensor, seg_ids: torch.Tensor,
           msgs: torch.Tensor) -> torch.Tensor:
    """``buf.index_add(0, seg_ids, msgs)``: messages added into a running
    (n, ...) buffer (a chunked segment sum)."""
    if isinstance(msgs, DTensor) or isinstance(seg_ids, DTensor):
        return buf + _scatter_sum_sharded(msgs, seg_ids, buf.shape[0])
    return buf.index_add(0, seg_ids, msgs)


def _as_dtensor(t, mesh):
    """``t`` as a DTensor: a plain tensor is whole on every rank."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def _dim0(placements) -> tuple:
    """Only dim 0's shards of ``placements``, the rest whole."""
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in placements)


def _contiguous_stride(shape) -> tuple:
    return tuple(torch.empty(tuple(shape), device="meta").stride())


def _gather_sharded(x, idx):
    """The rows ``idx`` of a sharded ``x``: ``x`` gathered whole on every
    rank, each rank taking the rows of its own ids; the result sharded as
    the ids' dim 0, and the whole source's grad a partial sum over the
    mesh dims that shard the ids (reduce-scattered onto ``x``'s
    shards)."""
    mesh = (x if isinstance(x, DTensor) else idx).device_mesh
    ids = _as_dtensor(idx, mesh)
    pl = _dim0(ids.placements)
    if tuple(ids.placements) != pl:
        ids = ids.redistribute(mesh, pl)
    whole = replicated(_as_dtensor(x, mesh)).to_local(grad_placements=[
        Partial() if isinstance(p, Shard) else Replicate() for p in pl])
    out = whole.index_select(0, ids.to_local())
    shape = (idx.shape[0], *x.shape[1:])
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _scatter_sum_sharded(msgs, seg_ids, n: int):
    """Each rank adds its own messages into a whole (n, ...) buffer: the
    buffers are partial sums over the mesh dims that shard the messages'
    dim 0, reduced at once onto the segments (a reduce-scatter over those
    mesh dims while their running product divides n, an all-reduce over
    the rest: an uneven or partial result would meet DTensor rules that
    break on it); the ids follow the messages' dim 0."""
    mesh = (msgs if isinstance(msgs, DTensor) else seg_ids).device_mesh
    m = _as_dtensor(msgs, mesh)
    pl = tuple(Replicate() if p.is_partial() else p for p in m.placements)
    if tuple(m.placements) != pl:
        m = m.redistribute(mesh, pl)
    ids = _as_dtensor(seg_ids, mesh)
    if tuple(ids.placements) != _dim0(pl):
        ids = ids.redistribute(mesh, _dim0(pl))
    loc = m.to_local()
    out = loc.new_zeros((n, *loc.shape[1:])).index_add(0, ids.to_local(),
                                                        loc)
    shape = (n, *msgs.shape[1:])
    partial = DTensor.from_local(
        out, mesh, tuple(Partial() if isinstance(p, Shard) and p.dim == 0
                         else p for p in pl), run_check=False, shape=shape,
        stride=_contiguous_stride(shape))
    target, prod = [], 1
    for i, p in enumerate(partial.placements):
        if p.is_partial() and n % (prod * mesh.size(i)) == 0:
            target.append(Shard(0))
            prod *= mesh.size(i)
        else:
            target.append(Replicate() if p.is_partial() else p)
    return partial.redistribute(mesh, tuple(target))


def _per_row(values: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """(E,) -> (E, 1, ..., 1) to broadcast against ``msgs``."""
    return values.reshape(-1, *(1,) * (msgs.ndim - 1))


def scatter_mean(msgs, seg_ids, n: int):
    s = scatter_sum(msgs, seg_ids, n)
    cnt = scatter_sum(msgs.new_ones((msgs.shape[0],)), seg_ids, n)
    return s / _per_row(cnt.clamp_min(1.0), msgs)


def scatter_max(msgs, seg_ids, n: int):
    """Per-segment max; empty segments yield 0 (not -inf) so isolated
    nodes don't poison downstream MLPs."""
    return on_whole(functools.partial(_scatter_max, n=n), msgs, seg_ids)


def _scatter_max(msgs, seg_ids, n: int):
    idx = _per_row(seg_ids.long(), msgs).expand_as(msgs)
    m = msgs.new_full((n, *msgs.shape[1:]), -torch.inf).scatter_reduce(
        0, idx, msgs, "amax", include_self=False)
    return torch.where(torch.isfinite(m), m, 0.0)


def scatter_min(msgs, seg_ids, n: int):
    return -scatter_max(-msgs, seg_ids, n)


def scatter_std(msgs, seg_ids, n: int, *, eps: float = 1e-5):
    """Per-segment standard deviation (PNA's 4th aggregator)."""
    mean = scatter_mean(msgs, seg_ids, n)
    sq = scatter_mean(msgs.square(), seg_ids, n)
    var = (sq - mean.square()).clamp_min(0.0)
    return torch.sqrt(var + eps)


SCATTER = {
    "sum": scatter_sum,
    "mean": scatter_mean,
    "max": scatter_max,
    "min": scatter_min,
    "std": scatter_std,
}


def degrees(seg_ids: torch.Tensor, n: int,
            dtype=torch.float32) -> torch.Tensor:
    ones = torch.ones(seg_ids.shape, dtype=dtype, device=seg_ids.device)
    return scatter_sum(ones, seg_ids, n)


def segment_softmax(scores, seg_ids, n: int):
    """Softmax of edge scores within each receiver segment.

    scores: (E, ...) -> (E, ...), normalized over edges sharing seg_id.
    """
    smax = scatter_max(scores, seg_ids, n)
    ex = torch.exp(scores - gather(smax, seg_ids))
    den = scatter_sum(ex, seg_ids, n)
    return ex / gather(den, seg_ids).clamp_min(1e-20)


def flatten_batched_graphs(x, senders, receivers):
    """(B, N, F) batched small graphs -> one big disjoint graph.

    Returns (x_flat (B*N, F), senders_flat, receivers_flat, graph_ids (B*N,)).
    Standard offset trick: edge indices of graph b get + b*N.
    """
    b, n = x.shape[0], x.shape[1]
    e = senders.shape[1]
    offs = (torch.arange(b, dtype=senders.dtype, device=senders.device)
            * n)[:, None]
    s_flat = (senders + offs).reshape(b * e)
    r_flat = (receivers + offs).reshape(b * e)
    graph_ids = (torch.arange(b * n, device=x.device) // n).to(torch.int32)
    return x.reshape(b * n, *x.shape[2:]), s_flat, r_flat, graph_ids
