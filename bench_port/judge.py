"""The comparison that decides ``correct``, and the control's precision.

Served logits are held against the plain reference's logits of the same
events: the number compared is the widest gap, over every compared event
and class, divided by the reference's largest logit (at least 1), so it
reads as a share of the logits' own scale.

The control is the reference with every matrix product's operands
rounded to TF32 (10 explicit mantissa bits, round to nearest with ties
away from zero, as the card's ``cvt.rna.tf32.f32``) and accumulated in
fp32: the arithmetic of a TF32 tensor-core product, which is the step
below fp32 that a later kernel would be tempted to take.  Done by
rounding rather than by ``allow_tf32`` so that the control reads the
same on the CPU, where a test keeps it, as on the card.
"""

from __future__ import annotations

import numpy as np
import torch

#: Bits of an fp32 mantissa that TF32 drops.
_TF32_DROP = 13


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) rounded to TF32's 10-bit mantissa, kept in fp32."""
    bits = t.contiguous().view(torch.int32)
    half = 1 << (_TF32_DROP - 1)
    mask = ~((1 << _TF32_DROP) - 1)
    return ((bits + half) & mask).view(torch.float32)


def logit_gap(served, ref) -> float:
    """The gap of one block (see :class:`GapMeter`)."""
    meter = GapMeter()
    meter.add(served, ref)
    return meter.gap


class GapMeter:
    """The widest gap over many compared blocks, on one common scale: the
    largest reference logit over all of them (at least 1)."""

    def __init__(self):
        self.diff = 0.0
        self.scale = 1.0
        self.events = 0
        self.bad = 0          # blocks missing, misshapen or non-finite

    def add(self, served, ref) -> None:
        ref = np.asarray(ref, np.float64)
        if served is None:
            self.bad += 1
            return
        served = np.asarray(served, np.float64)
        if served.shape != ref.shape or not np.isfinite(served).all():
            self.bad += 1
            return
        if ref.size:
            self.diff = max(self.diff, float(np.abs(served - ref).max()))
            self.scale = max(self.scale, float(np.abs(ref).max()))
        self.events += ref.shape[0]

    @property
    def gap(self) -> float:
        return float("inf") if self.bad else self.diff / self.scale
