"""All-to-all MoE dispatch across the ranks of a process group.

Port of ``repro.parallel.moe_dispatch``.  The global dispatch of
``models/moe.py`` moves every token to every expert's buffer; under
sharding that is an all-gather of the whole payload.  The
communication-optimal dispatch is two all-to-alls, one each way:

  per rank (T_loc tokens):
    1. route locally with ``models/moe.py``'s pieces (``route``: the
       router product, fp32 softmax, a stable top-k with ties to the
       lower expert; ``dispatch_slots``: a stable sort by expert, the
       position from ``searchsorted`` left, kept while below a fixed
       per-(rank, expert) capacity C_loc, dropped beyond — the global
       path's dropping semantics, applied per rank);
    2. build the local send buffer (E, C_loc, d);
    3. ``all_to_all_single`` over the expert axis: rank r receives its
       E/S experts' buffers from every rank, (S, E/S, C_loc, d);
    4. the SwiGLU of its local experts over (E/S, S * C_loc, d);
    5. the reverse all-to-all, and the combine with the gate weights.

The reference's ``lax.all_to_all`` calls become ``all_to_all_single`` on
contiguous buffers and its ``axis_index`` the rank in the group.  The
reference's receive reshape (``src/repro/parallel/moe_dispatch.py:86``)
reads the (S, E/S, C_loc, d) buffer as if it were (E/S, S, C_loc, d),
which sends tokens to the wrong experts whenever a rank owns more than
one expert; the port transposes the two axes first (see
:func:`a2a_moe_shard`), so it agrees with the global ``moe_apply`` at
every E/S and with the reference's dispatch where E/S = 1.

Forward only: ``torch.distributed``'s collectives carry no autograd.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as moe_lib
from repro_torch.nn import core as nn


def local_route(x_loc, expert_ids, moe: MoEConfig, cap: int):
    """Per-rank routing. x_loc: (T_loc, d); expert_ids: (T_loc, k).

    Returns (send (E, cap, d), slot (T_loc * k,)): each assignment's row
    of the send buffer in (token, k) order, ``E * cap`` where dropped.
    """
    t, d = x_loc.shape
    k = expert_ids.shape[1]
    e = moe.n_experts
    slot = moe_lib.dispatch_slots(expert_ids, moe, cap)
    send = x_loc.new_zeros((e * cap + 1, d)).index_copy(
        0, slot, x_loc[:, None].expand(t, k, d).reshape(t * k, d))
    return send[:-1].view(e, cap, d), slot


def a2a_moe_shard(x_loc, params, moe: MoEConfig, cap: int, group=None, *,
                  activation: str = "silu", compute_dtype=None):
    """One rank's MoE forward over ``group`` (default: the world).

    x_loc: (T_loc, d), this rank's tokens.  params: the whole layer's, as
    ``models/moe.init_moe`` makes them, on every rank; rank r runs experts
    ``[r * E/S, (r + 1) * E/S)``.  Returns (T_loc, d) in the compute
    dtype (x's by default).
    """
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    e, k = moe.n_experts, moe.top_k
    if e % n:
        raise ValueError(f"{e} experts do not divide over {n} ranks")
    e_loc = e // n
    t, d = x_loc.shape
    cdt = nn.as_dtype(compute_dtype or x_loc.dtype)
    act = nn.ACTIVATIONS[activation]

    xc = x_loc.to(cdt)
    _, gates, expert_ids = moe_lib.route(params, moe, xc, compute_dtype=cdt)
    send, slot = local_route(xc, expert_ids, moe, cap)

    # all-to-all: the send buffer's e_loc-expert blocks go to their ranks,
    # in rank order; rank r receives (S, E/S, cap, d): ITS experts'
    # buffers from every rank.
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # (S, E/S) -> (E/S, S) before merging S into the slot axis: the
    # reference (moe_dispatch.py:86) reshapes without the transpose, which
    # hands rank s's tokens for expert j to another expert when E/S > 1.
    h = recv.view(n, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, n * cap, d)

    w = {name: params["experts"][name][rank * e_loc:(rank + 1) * e_loc]
         .to(cdt) for name in ("w_gate", "w_in", "w_out")}
    y = nn.dot(act(nn.dot(h, w["w_gate"])) * nn.dot(h, w["w_in"]),
               w["w_out"])                                  # (E/S, S*cap, d)

    # reverse all-to-all back to the sending ranks: each receives (S, E/S,
    # cap, d), its tokens' rows in global expert order
    back_send = y.view(e_loc, n, cap, d).transpose(0, 1).contiguous()
    back = torch.empty_like(back_send)
    dist.all_to_all_single(back, back_send, group=group)
    y_flat = torch.cat([back.view(e * cap, d), back.new_zeros((1, d))])

    per_assign = y_flat[slot].view(t, k, d)
    out = (per_assign * gates.to(y.dtype)[..., None]).float().sum(1)
    return out.to(cdt)


def a2a_moe(x, params, moe_cfg: MoEConfig, group=None, *,
            activation: str = "silu", compute_dtype=None):
    """The dispatch over ``group`` on a whole batch: x (T, d), the same on
    every rank, is split into equal token slices, one per rank, and the
    whole (T, d) output is gathered back on every rank.

    Tokens must divide the group size.  The per-rank capacity is
    ``models/moe.capacity(T // S)``: the global path's in expectation.
    """
    n = dist.get_world_size(group)
    t = x.shape[0]
    if t % n:
        raise ValueError(f"{t} tokens do not divide over {n} ranks")
    cap = moe_lib.capacity(t // n, moe_cfg)
    x_loc = x.chunk(n)[dist.get_rank(group)]
    y_loc = a2a_moe_shard(x_loc, params, moe_cfg, cap, group,
                          activation=activation, compute_dtype=compute_dtype)
    parts = [torch.empty_like(y_loc) for _ in range(n)]
    dist.all_gather(parts, y_loc.contiguous(), group=group)
    return torch.cat(parts)
