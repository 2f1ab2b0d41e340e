"""MeshGraphNet (arXiv:2010.03409): encode-process-decode with edge features.

Port of ``repro.models.gnn.meshgraphnet``.

Encoder: node MLP + edge MLP (edge features = relative position, |dx|, plus
any provided edge attributes).  Processor: n_layers message-passing blocks,
each with an edge-update MLP(e, h_src, h_dst) and node-update MLP(h, sum_e)
with residuals and LayerNorm (the paper's configuration: 15 blocks, width
128, 2-layer MLPs).  Decoder: node MLP.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import segment_ops as seg
from repro_torch.nn import core as nn
from repro_torch.parallel.sharding import constrain


def _mlp_init(key, d_in, d_hidden, d_out, n_layers, *, with_ln=True,
              device="cuda"):
    hidden = [d_hidden] * max(n_layers - 1, 1)
    p = {"mlp": nn.mlp_init(key, d_in, hidden, d_out, device=device)}
    if with_ln:
        p["ln"] = nn.layernorm_init(d_out, device=device)
    return p


def _mlp_apply(p, x, activation):
    y = nn.mlp_apply(p["mlp"], x, activation=activation)
    if "ln" in p:
        y = nn.layernorm_apply(p["ln"], y)
    return y


def edge_geometry(graph):
    """Relative displacement + distance as base edge features."""
    pos = graph.get("pos")
    s, r = graph["senders"], graph["receivers"]
    feats = []
    if pos is not None:
        dx = seg.gather(pos, s) - seg.gather(pos, r)
        feats += [dx, torch.linalg.vector_norm(dx, dim=-1, keepdim=True)]
    if graph.get("edge_attr") is not None:
        feats.append(graph["edge_attr"])
    if not feats:
        feats = [torch.ones((s.shape[0], 1), dtype=torch.float32,
                            device=s.device)]
    return torch.cat(feats, -1)


def edge_feat_dim(graph_spec: dict) -> int:
    d = 0
    if graph_spec.get("pos") is not None:
        d += 4
    if graph_spec.get("edge_attr") is not None:
        d += graph_spec["edge_attr"].shape[-1]
    return d or 1


def init(key_or_seed, cfg: GNNConfig, d_in: int, n_out: int, *,
         d_edge_in: int = 4, device="cuda"):
    """Params on ``device``: a ``prng`` key replays the reference's init
    at that key; an int or a ``torch.Generator`` draws torch's own."""
    d, nl = cfg.d_hidden, cfg.mlp_layers
    keys = nn.split_source(key_or_seed, 3 + 2 * cfg.n_layers)
    params = {
        "gnn_node_enc": _mlp_init(keys[0], d_in, d, d, nl, device=device),
        "gnn_edge_enc": _mlp_init(keys[1], d_edge_in, d, d, nl,
                                  device=device),
        "gnn_decoder": _mlp_init(keys[2], d, d, n_out, nl, with_ln=False,
                                 device=device),
        "gnn_blocks": [],
    }
    for i in range(cfg.n_layers):
        params["gnn_blocks"].append({
            "edge": _mlp_init(keys[3 + 2 * i], 3 * d, d, d, nl,
                              device=device),
            "node": _mlp_init(keys[4 + 2 * i], 2 * d, d, d, nl,
                              device=device),
        })
    return params


def apply(params, cfg: GNNConfig, graph):
    s, r = graph["senders"], graph["receivers"]
    n = graph["x"].shape[0]
    act = cfg.activation

    h = _mlp_apply(params["gnn_node_enc"], graph["x"], act)
    e = _mlp_apply(params["gnn_edge_enc"], edge_geometry(graph), act)
    h = constrain(h, "nodes", None)
    e = constrain(e, "edges", None)

    for blk in params["gnn_blocks"]:
        hs, hr = seg.gather(h, s), seg.gather(h, r)
        e = e + _mlp_apply(blk["edge"], torch.cat([e, hs, hr], -1), act)
        e = constrain(e, "edges", None)
        agg = seg.scatter_sum(e, r, n)
        h = h + _mlp_apply(blk["node"], torch.cat([h, agg], -1), act)
        h = constrain(h, "nodes", None)
    return _mlp_apply(params["gnn_decoder"], h, act)
