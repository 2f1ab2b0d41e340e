"""Learning-rate schedules (step -> lr), port of ``repro.training.schedule``.

Includes WSD (warmup-stable-decay) from MiniCPM [arXiv:2404.06395] plus
the standard warmup-cosine and constant schedules.

The step is the train state's 0-d int32 tensor on the device, so the
learning rate is computed there, as a 0-d fp32 tensor, with no host
sync; a Python int works too (the result then lies on the CPU).  Every
operation runs in fp32 with the Python constants rounded to fp32 where
they meet a tensor, as ``jnp`` does with weakly typed scalars, so the
rates follow the reference's to within an ulp of ``cos`` / ``pow``.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def constant(lr: float):
    def f(step):
        device = step.device if isinstance(step, torch.Tensor) else None
        return torch.tensor(lr, dtype=torch.float32, device=device)
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = t.clamp(0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)
    return f


def wsd(lr: float, warmup_steps: int, total_steps: int,
        decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup -> stable plateau -> short exponential-ish decay (MiniCPM).

    decay starts at (1 - decay_frac) * total_steps; within the decay phase
    lr falls geometrically to final_frac * lr.
    """
    decay_start = int(total_steps * (1.0 - decay_frac))

    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup_steps, 1)
        t = (step - decay_start) / max(total_steps - decay_start, 1)
        t = t.clamp(0.0, 1.0)
        decay = lr * torch.pow(final_frac, t)
        stable = torch.full_like(step, lr)
        return torch.where(step < warmup_steps, warm,
                           torch.where(step < decay_start, stable, decay))
    return f


SCHEDULES = {
    "constant": constant,
    "warmup_cosine": warmup_cosine,
    "wsd": wsd,
}
