"""Plain PyTorch JEDI-linear forwards: O(N_o) aggregation + its oracle.

Port of ``repro.kernels.jedi_linear.ref``.  f_R's first layer is
linear, so it commutes with the sum over senders:

    Ebar1_i = sum_{j != i} (W_r x_i + W_s x_j + b1)
            = (N_o - 1) (W_r x_i + b1) + (sum_j W_s x_j - W_s x_i)

two per-node projections, one pool of ``u_s`` and a per-node
recombination; the remaining f_R layers then run per node.  This is a
different model from JEDI-net (the first nonlinearity sees the
aggregated message), with its own reference:

* :func:`forward_jedi_linear`          — the O(N_o) pooled path.
* :func:`forward_jedi_linear_edge_sum` — the same model evaluated over
  the (N_o, N_o, H1) first-layer grid with the self-edge masked, summed
  before the activation: the oracle registered as the ``ref`` of every
  jedi_linear path.

Both round where the reference rounds: biases of the layers after the
first are added in the compute dtype, through ``nn.matmul`` /
``nn.mlp_apply`` (the kernel keeps them fp32; see ``linear_kernel.py``).
"""

from __future__ import annotations

import torch

from repro_torch.nn import core as nn


def _cdt(cfg) -> torch.dtype:
    return nn.as_dtype(cfg.compute_dtype)


def first_layer_split(params, cfg, x):
    """Bilinear-split first f_R layer: ``u_r``, ``u_s`` (fp32) and ``b1``.

    w1 rows [:P] receive, [P:] send; the projections are taken in the
    compute dtype and held in fp32 after, so the (N_o-1)-fold
    recombination does not amplify another rounding.
    """
    cdt = _cdt(cfg)
    layers = params["fr"]["layers"]
    w1 = layers[0]["w"].to(cdt)
    b1 = layers[0]["b"].float()
    p = cfg.n_features
    x = x.to(cdt)
    u_r = nn.matmul(x, w1[:p]).float()                 # (B, N_o, H1)
    u_s = nn.matmul(x, w1[p:]).float()                 # (B, N_o, H1)
    return u_r, u_s, b1


def _tail(params, cfg, x, h):
    """Post-aggregation network shared by both forwards: remaining f_R
    layers per node, C = [x ‖ Ebar], f_O, node sum, phi_O."""
    cdt = _cdt(cfg)
    act = nn.ACTIVATIONS[cfg.activation]
    layers = params["fr"]["layers"]
    if len(layers) > 1:
        h = act(h)
    for i, lp in enumerate(layers[1:]):
        h = nn.matmul(h.to(cdt), lp["w"].to(cdt)) + lp["b"].to(cdt)
        if i < len(layers) - 2:
            h = act(h)
    c = torch.cat([x.to(cdt), h.to(cdt)], dim=-1)
    o = nn.mlp_apply(params["fo"], c, activation=cfg.activation,
                     compute_dtype=cdt)                # (B, N_o, D_o)
    o_sum = nn.sum_upcast(o, -2)
    logits = nn.mlp_apply(params["phi"], o_sum, activation=cfg.activation,
                          compute_dtype=cdt)
    return logits.float()


def forward_jedi_linear(params, cfg, x):
    """O(N_o) JEDI-linear forward. x: (B, N_o, P) -> logits (B, n_targets)."""
    x = x.to(_cdt(cfg))
    u_r, u_s, b1 = first_layer_split(params, cfg, x)
    pooled = u_s.sum(-2, keepdim=True)                 # (B, 1, H1)
    h = (cfg.n_objects - 1) * (u_r + b1) + (pooled - u_s)
    return _tail(params, cfg, x, h)


def forward_jedi_linear_edge_sum(params, cfg, x):
    """O(N_o^2) oracle: the pooled identity expanded back into the grid,
    the self-edge zeroed, summed over senders before the activation."""
    x = x.to(_cdt(cfg))
    u_r, u_s, b1 = first_layer_split(params, cfg, x)
    grid = u_r[:, :, None, :] + u_s[:, None, :, :] + b1   # (B, N_o, N_o, H1)
    mask = 1.0 - torch.eye(cfg.n_objects, dtype=grid.dtype,
                           device=grid.device)
    h = (grid * mask[None, :, :, None]).sum(-2)            # (B, N_o, H1)
    return _tail(params, cfg, x, h)
