"""Public entry of the FM interaction kernel (B4)."""

from __future__ import annotations

import torch

from repro_torch.kernels.fm_interaction import kernel as K


def fm_interaction(v: torch.Tensor) -> torch.Tensor:
    """v: (B, F, K) per-field embeddings (fp32 or bf16) -> (B,) fp32
    pairwise-interaction term.  On the card one launch of kernel B4, for
    any B; on the CPU its plain version."""
    return K.fm_interaction_kernel_call(v)
