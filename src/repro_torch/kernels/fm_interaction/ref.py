"""Plain PyTorch version of the FM interaction kernel."""

from __future__ import annotations

import torch


def fm_interaction_ref(v: torch.Tensor) -> torch.Tensor:
    """v: (B, F, K) -> (B,) float32: sum_{i<j} <v_i, v_j>, as
    0.5 * sum_k [(sum_f v)^2 - sum_f v^2] in fp32."""
    v = v.float()
    sum_v = v.sum(-2)
    sum_sq = v.square().sum(-2)
    return 0.5 * (sum_v.square() - sum_sq).sum(-1)
