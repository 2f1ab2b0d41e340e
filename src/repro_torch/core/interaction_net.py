"""JEDI-net interaction network (the paper's end-to-end application).

Port of ``repro.core.interaction_net``.  The forward paths:

* ``forward_dense``      — the paper-[5] baseline: explicit dense MMMs
  with the one-hot relation matrices Rr / Rs (plain PyTorch).
* ``forward_sr``         — strength reduction (Sec 3.1), edge-major
  layout (Sec 3.2) and aggregation as a reshape + sum (Sec 3.3).
* ``forward_sr_split``   — SR + bilinear first-layer split + dense grid.
* ``forward_fused``      — the edge block (B-construct + f_R + MMM3) in
  one hand-written CUDA kernel (``kernels/csrc/fused_jedinet_edge.cu``),
  f_O / phi_O in plain PyTorch.
* ``forward_fused_full`` — the whole network in ONE hand-written CUDA
  kernel per batch (``kernels/csrc/fused_jedinet_full.cu``).

On CPU tensors the kernel paths run their kernels' plain PyTorch
versions.  Layout: inputs are (batch, N_o, P), each node's features
contiguous.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.common import prng
from repro_torch.core import adjacency, paths
from repro_torch.nn import core as nn


@dataclasses.dataclass(frozen=True)
class JediNetConfig:
    """JEDI-net hyper-parameters (Table 2 of the paper); see the reference
    for the provenance of each default."""

    n_objects: int = 30          # N_o: particles per jet (30p / 50p datasets)
    n_features: int = 16         # P: features per particle
    d_e: int = 8                 # f_R output (edge hidden features)
    d_o: int = 24                # f_O output (per-node post-interaction repr)
    n_targets: int = 5           # jet classes: g, q, W, Z, t
    fr_hidden: Sequence[int] = (20, 20, 20)
    fo_hidden: Sequence[int] = (20, 20, 20)
    phi_hidden: Sequence[int] = (20, 20, 20)
    activation: str = "relu"
    compute_dtype: str = "float32"

    @property
    def n_edges(self) -> int:
        return self.n_objects * (self.n_objects - 1)

    def with_(self, **kw) -> "JediNetConfig":
        return dataclasses.replace(self, **kw)


def init(seed, cfg: JediNetConfig, *, scale: str = "fan_in", device="cuda"):
    """Random params from ``seed``, drawn on the CPU and moved to
    ``device``.  ``scale="lecun"`` keeps an untrained net's activations
    O(1) through the N_o-way message sums.

    ``seed`` is an int or a ``torch.Generator`` (torch's own draws, which
    differ from the JAX init of the same seed; parity tests carry JAX
    params across with ``bridge.params_from_jax``), or a key of
    :mod:`repro_torch.common.prng`: ``init(prng.key(s), cfg)`` is the
    reference's ``init(jax.random.PRNGKey(s), cfg)``, its key split in
    the same way, each weight within a few ulps of the reference's.
    """
    dev = resolve_device(device)
    if isinstance(seed, np.ndarray):                   # a prng key
        kfr, kfo, kphi = prng.split(seed, 3)
    else:
        kfr = kfo = kphi = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
    kw = dict(scale=scale, device=dev)
    return {
        "fr": nn.mlp_init(kfr, 2 * cfg.n_features, cfg.fr_hidden, cfg.d_e,
                          **kw),
        "fo": nn.mlp_init(kfo, cfg.n_features + cfg.d_e, cfg.fo_hidden,
                          cfg.d_o, **kw),
        "phi": nn.mlp_init(kphi, cfg.d_o, cfg.phi_hidden, cfg.n_targets,
                           **kw),
    }


def _cdt(cfg: JediNetConfig) -> torch.dtype:
    return nn.as_dtype(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Paper-[5] baseline: explicit dense MMMs with Rr / Rs.
# ---------------------------------------------------------------------------

def forward_dense(params, cfg: JediNetConfig, x):
    """Baseline JEDI-net with explicit adjacency MMMs (B1 = I@Rr,
    B2 = I@Rs, Ebar = E@Rr^T in the paper's (P, N_o) layout)."""
    cdt = _cdt(cfg)
    rr_np, rs_np = adjacency.dense_relation_matrices(cfg.n_objects)
    rr = torch.as_tensor(rr_np, device=x.device).to(cdt)
    rs = torch.as_tensor(rs_np, device=x.device).to(cdt)

    i_mat = x.to(cdt).transpose(-1, -2)                    # (B, P, N_o)
    b1 = nn.matmul(i_mat, rr)                              # MMM1: (B, P, N_E)
    b2 = nn.matmul(i_mat, rs)                              # MMM2: (B, P, N_E)
    b = torch.cat([b1, b2], dim=-2)                        # (B, 2P, N_E)
    e_cols = nn.mlp_apply(params["fr"], b.transpose(-1, -2),
                          activation=cfg.activation, compute_dtype=cdt)
    ebar = nn.matmul(e_cols.transpose(-1, -2), rr.T)       # MMM3: (B, D_e, N_o)
    c = torch.cat([i_mat, ebar], dim=-2)                   # (B, P+D_e, N_o)
    o = nn.mlp_apply(params["fo"], c.transpose(-1, -2),
                     activation=cfg.activation, compute_dtype=cdt)
    o_sum = nn.sum_upcast(o, -2)                           # (B, D_o)
    logits = nn.mlp_apply(params["phi"], o_sum, activation=cfg.activation,
                          compute_dtype=cdt)
    return logits.float()


# ---------------------------------------------------------------------------
# Strength-reduced, edge-major path.
# ---------------------------------------------------------------------------

def build_b_matrix(cfg: JediNetConfig, x):
    """Strength-reduced MMM1/MMM2: B (B, N_E, 2P) as a broadcast of the
    receiver and one static gather of the senders — zero FLOPs."""
    n_o, p = cfg.n_objects, cfg.n_features
    send_idx = torch.as_tensor(adjacency.sender_index_matrix(n_o),
                               dtype=torch.long, device=x.device)
    lead = x.shape[:-2]
    b1 = x[..., :, None, :].expand(*lead, n_o, n_o - 1, p)
    b2 = x.index_select(x.dim() - 2, send_idx.reshape(-1))
    b2 = b2.reshape(*lead, n_o, n_o - 1, p)
    b = torch.cat([b1, b2], dim=-1)
    return b.reshape(*lead, cfg.n_edges, 2 * p)


def aggregate_incoming(cfg: JediNetConfig, e_cols):
    """Strength-reduced MMM3: Ebar = E @ Rr^T as a reshape + sum over k."""
    n_o = cfg.n_objects
    e_r = e_cols.reshape(*e_cols.shape[:-2], n_o, n_o - 1, e_cols.shape[-1])
    return nn.sum_upcast(e_r, -2)


def forward_sr(params, cfg: JediNetConfig, x, *,
               return_intermediates: bool = False):
    """Strength-reduced JEDI-net forward. x: (batch, N_o, P)."""
    cdt = _cdt(cfg)
    x = x.to(cdt)
    b = build_b_matrix(cfg, x)
    e_cols = nn.mlp_apply(params["fr"], b, activation=cfg.activation,
                          compute_dtype=cdt)
    ebar = aggregate_incoming(cfg, e_cols)
    c = torch.cat([x, ebar], dim=-1)
    o = nn.mlp_apply(params["fo"], c, activation=cfg.activation,
                     compute_dtype=cdt)
    o_sum = nn.sum_upcast(o, -2)
    logits = nn.mlp_apply(params["phi"], o_sum, activation=cfg.activation,
                          compute_dtype=cdt).float()
    if return_intermediates:
        return logits, {"b": b, "e": e_cols, "ebar": ebar, "c": c, "o": o}
    return logits


def forward_sr_split(params, cfg: JediNetConfig, x, *, grid: bool = True):
    """Strength reduction + bilinear first-layer split (+ dense grid).

    f_R's first layer splits over the [x_r ‖ x_s] concatenation, so the
    two projections run once per node.  ``grid=True`` computes the full
    N_o x N_o grid and subtracts the self-edge diagonal after the sum;
    ``grid=False`` gathers the (N_o, N_o-1) sender table instead.
    """
    cdt = _cdt(cfg)
    x = x.to(cdt)
    act = nn.ACTIVATIONS[cfg.activation]
    layers = params["fr"]["layers"]
    w1 = layers[0]["w"].to(cdt)
    b1 = layers[0]["b"].to(cdt)
    p = cfg.n_features
    u_r = nn.matmul(x, w1[:p])                             # (B, N_o, H1)
    u_s = nn.matmul(x, w1[p:])                             # (B, N_o, H1)
    if grid:
        h = u_r[:, :, None, :] + u_s[:, None, :, :] + b1   # (B, N_o, N_o, H1)
    else:
        send_idx = torch.as_tensor(
            adjacency.sender_index_matrix(cfg.n_objects), dtype=torch.long,
            device=x.device)
        h = u_r[:, :, None, :] + u_s[:, send_idx, :] + b1
    if len(layers) > 1:
        h = act(h)
    for i, lp in enumerate(layers[1:]):
        h = nn.matmul(h, lp["w"].to(cdt)) + lp["b"].to(cdt)
        if i < len(layers) - 2:
            h = act(h)
    if grid:
        total = nn.sum_upcast(h, 2)                        # (B, N_o, D_e)
        diag = torch.diagonal(h, dim1=1, dim2=2).transpose(-1, -2)
        ebar = total - diag
    else:
        ebar = nn.sum_upcast(h, 2)
    c = torch.cat([x, ebar.to(cdt)], dim=-1)
    o = nn.mlp_apply(params["fo"], c, activation=cfg.activation,
                     compute_dtype=cdt)
    o_sum = nn.sum_upcast(o, -2)
    logits = nn.mlp_apply(params["phi"], o_sum, activation=cfg.activation,
                          compute_dtype=cdt)
    return logits.float()


# ---------------------------------------------------------------------------
# Fused path: one hand-written CUDA kernel for the edge block (Sec 3.5).
# ---------------------------------------------------------------------------

def forward_fused(params, cfg: JediNetConfig, x):
    """JEDI-net forward with the edge block in one CUDA kernel.

    The kernel computes Ebar directly from x without materializing B or
    E in device memory (the Sec 3.5 sub-layer fusion); f_O / phi_O stay
    plain PyTorch, as the reference leaves them to XLA.  ``params`` are
    raw MLP params or the bound form from :func:`_bind_edge` (f_R packed
    for the kernel).  On CPU tensors the kernel's plain version runs.
    """
    from repro_torch.kernels.fused_jedinet import ops as fused_ops
    cdt = _cdt(cfg)
    x = x.to(cdt)
    ebar = fused_ops.fused_edge_block(params["fr"], cfg, x)
    c = torch.cat([x, ebar.to(cdt)], dim=-1)
    o = nn.mlp_apply(params["fo"], c, activation=cfg.activation,
                     compute_dtype=cdt)
    o_sum = nn.sum_upcast(o, -2)
    logits = nn.mlp_apply(params["phi"], o_sum, activation=cfg.activation,
                          compute_dtype=cdt)
    return logits.float()


def _bind_edge(params, cfg):
    """The params with f_R bound for the edge kernel (f_O / phi_O kept)."""
    from repro_torch.kernels.fused_jedinet import ops as fused_ops
    return dict(params, fr=fused_ops.bind_edge(params["fr"], cfg))


def _edge_layout(cfg, params):
    from repro_torch.kernels.fused_jedinet import autotune
    return autotune.edge_layout_for(cfg, params)


# ---------------------------------------------------------------------------
# Whole-network fused path: one hand-written CUDA kernel (x -> logits).
# ---------------------------------------------------------------------------

def forward_fused_full(params, cfg: JediNetConfig, x):
    """JEDI-net forward as ONE whole-network kernel (x -> logits).

    Bilinear-split f_R, the masked receiver x sender grid, the sender
    sum, f_O, the node sum and phi_O run in one CUDA kernel per batch;
    only weights and x are read from device memory and only the logits
    written.  ``params`` are raw MLP params or the bound form from
    :func:`~repro_torch.kernels.fused_jedinet.ops.bind_full`.  On CPU
    tensors the kernel's plain PyTorch version runs instead.
    """
    from repro_torch.kernels.fused_jedinet import ops as fused_ops
    return fused_ops.fused_forward_full(params, cfg, x)


def _bind_full(params, cfg):
    from repro_torch.kernels.fused_jedinet import ops as fused_ops
    return fused_ops.bind_full(params, cfg)


def _full_layout(cfg, params):
    from repro_torch.kernels.fused_jedinet import autotune
    return autotune.full_layout_for(cfg, params)


# ---------------------------------------------------------------------------
# Path registration (see core/paths.py).
# ---------------------------------------------------------------------------

paths.register(paths.PathSpec(
    name="dense", forward=forward_dense, ref=forward_sr,
    fused_level="none", tolerance=2e-4,
    complexity="O(N^2)", fallback=None,
    description="paper-[5] baseline: explicit Rr/Rs MMMs"))
paths.register(paths.PathSpec(
    name="sr", forward=forward_sr, ref=forward_dense,
    fused_level="none", tolerance=2e-4,
    complexity="O(N^2)", fallback=None,
    description="strength reduction + edge-major layout (Sec 3.1-3.3)"))
paths.register(paths.PathSpec(
    name="sr_split", forward=forward_sr_split, ref=forward_sr,
    fused_level="none", tolerance=2e-4,
    complexity="O(N^2)", fallback=None,
    description="SR + bilinear first-layer split + dense grid (torch)"))
paths.register(paths.PathSpec(
    name="fused", forward=forward_fused, ref=forward_sr,
    fused_level="edge", cuda=True, tolerance=5e-4,
    bind_params=_bind_edge,
    per_sample_bytes=lambda cfg, p: _edge_layout(cfg, p).batch_bytes,
    reserved_bytes=lambda cfg, p: _edge_layout(cfg, p).reserved_bytes,
    complexity="O(N^2)", fallback="sr",
    description="edge-block CUDA kernel: B-construct + f_R + MMM3 on-chip"))
paths.register(paths.PathSpec(
    name="fused_full", forward=forward_fused_full, ref=forward_sr,
    fused_level="full", cuda=True, tolerance=5e-4,
    bind_params=_bind_full,
    per_sample_bytes=lambda cfg, p: _full_layout(cfg, p).batch_bytes,
    reserved_bytes=lambda cfg, p: _full_layout(cfg, p).reserved_bytes,
    complexity="O(N^2)", fallback="sr_split",
    description="whole-network CUDA kernel: x -> logits on-chip"))


def loss_fn(params, cfg: JediNetConfig, batch, *, forward: str = "sr"):
    """Softmax cross-entropy over the jet classes through any registered
    path; its params transform runs first.  Training through a quantized
    path has flat gradients (no straight-through estimator), so it warns.
    """
    spec = paths.get(forward)
    if spec.quantized:
        warnings.warn(
            f"loss_fn through quantized path {forward!r}: the params "
            "transform rounds weights with no straight-through estimator, "
            "so gradients through the quantizer are degenerate (flat). "
            "Train on an fp32 path and quantize at serving time.",
            UserWarning, stacklevel=2)
    logits = spec.forward(spec.prepare_params(params), cfg, batch["x"])
    y = batch["y"].long()
    nll = F.cross_entropy(logits, y)
    acc = (logits.argmax(-1) == y).float().mean()
    return nll, {"accuracy": acc}
