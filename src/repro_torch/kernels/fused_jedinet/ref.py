"""Plain PyTorch oracle for the fused JEDI-net edge block (kernel B3).

Port of ``repro.kernels.fused_jedinet.ref``.  Computes Ebar = (sum of
f_R messages over incoming edges) per node, i.e. MMM1/2 + f_R + MMM3 of
the paper, using the strength-reduced but UNFUSED path (the explicit B
matrix of every edge in memory).  It is independent of the kernel's
design: :func:`~repro_torch.kernels.fused_jedinet.kernel.fused_edge_block_plain`
follows the kernel's summation order, this oracle sums the senders with
``torch.sum``, so the two agree to fp32 rounding.
"""

from __future__ import annotations

import torch

from repro_torch.core import adjacency
from repro_torch.nn import core as nn


def fused_edge_block_ref(params_fr, cfg, x):
    """x: (B, N_o, P) -> Ebar (B, N_o, D_e), float32."""
    n_o, p = cfg.n_objects, cfg.n_features
    send_idx = torch.from_numpy(
        adjacency.sender_index_matrix(n_o)).to(x.device)      # (N_o, N_o-1)

    b1 = x[..., :, None, :].expand(*x.shape[:-2], n_o, n_o - 1, p)
    b2 = x.index_select(-2, send_idx.reshape(-1))
    b2 = b2.reshape(*x.shape[:-2], n_o, n_o - 1, p)
    b = torch.cat([b1, b2], dim=-1)                           # receiver||sender

    e = nn.mlp_apply(params_fr, b.float(), activation=cfg.activation,
                     compute_dtype=torch.float32)              # (B, N_o, N_o-1, D_e)
    return e.sum(-2).float()                                   # (B, N_o, D_e)
