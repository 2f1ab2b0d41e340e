"""PNA — Principal Neighbourhood Aggregation (arXiv:2004.05718).

Port of ``repro.models.gnn.pna``.

Per layer: edge message MLP(h_src || h_dst) -> 4 aggregators
(mean/max/min/std) x 3 degree scalers (identity / amplification log(d+1)/δ /
attenuation δ/log(d+1)) -> concat (12 x d) -> post linear + residual.
δ is the mean log-degree of the training graph (estimated online here).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import segment_ops as seg
from repro_torch.nn import core as nn
from repro_torch.parallel.sharding import constrain

SCALERS = ("identity", "amplification", "attenuation")


def init(key_or_seed, cfg: GNNConfig, d_in: int, n_out: int, *,
         device="cuda"):
    """Params on ``device``: a ``prng`` key replays the reference's init
    at that key; an int or a ``torch.Generator`` draws torch's own."""
    d = cfg.d_hidden
    n_agg = len(cfg.aggregators) * len(cfg.scalers)
    keys = nn.split_source(key_or_seed, 3 + cfg.n_layers * 2)
    params = {
        "gnn_encoder": nn.dense_init(keys[0], d_in, d, device=device),
        "gnn_layers": [],
        "gnn_decoder": nn.dense_init(keys[1], d, n_out, device=device),
    }
    for i in range(cfg.n_layers):
        params["gnn_layers"].append({
            "msg": nn.dense_init(keys[2 + 2 * i], 2 * d, d, device=device),
            "post": nn.dense_init(keys[3 + 2 * i], n_agg * d, d,
                                  device=device),
        })
    return params


def _scale(agg, scaler: str, logdeg, delta):
    if scaler == "identity":
        return agg
    if scaler == "amplification":
        return agg * (logdeg / delta)
    if scaler == "attenuation":
        return agg * (delta / logdeg.clamp_min(1e-5))
    raise ValueError(scaler)


def apply(params, cfg: GNNConfig, graph):
    x = graph["x"]
    s, r = graph["senders"], graph["receivers"]
    n = x.shape[0]
    act = nn.ACTIVATIONS[cfg.activation]

    deg = seg.degrees(r, n)
    logdeg = torch.log1p(deg)[:, None]
    delta = logdeg.mean().clamp_min(1e-5)

    h = act(nn.dense_apply(params["gnn_encoder"], x))
    h = constrain(h, "nodes", None)
    for lp in params["gnn_layers"]:
        hs, hr = seg.gather(h, s), seg.gather(h, r)
        m = act(nn.dense_apply(lp["msg"], torch.cat([hs, hr], -1)))
        m = constrain(m, "edges", None)
        aggs = []
        for agg_name in cfg.aggregators:
            a = seg.SCATTER[agg_name](m, r, n)
            for scaler in cfg.scalers:
                aggs.append(_scale(a, scaler, logdeg, delta))
        z = torch.cat(aggs, -1)
        h = h + act(nn.dense_apply(lp["post"], z))
        h = constrain(h, "nodes", None)
    return nn.dense_apply(params["gnn_decoder"], h)
