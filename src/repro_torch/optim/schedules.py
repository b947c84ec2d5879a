"""Learning-rate schedules as step → scale functions (they multiply the peak lr).

Port of ``repro.optim.schedules``: the arithmetic is the reference's, in float32
tensors (a step may be an int or a 0-d integer tensor), and the scale comes
back as a 0-d float32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule():
    return lambda step: torch.ones((), dtype=torch.float32, device=torch.as_tensor(step).device)


def linear_schedule(total_steps: int, end_frac: float = 0.0):
    def f(step):
        t = torch.clamp_max(_f32(step) / max(total_steps, 1), 1.0)
        return 1.0 + (end_frac - 1.0) * t

    return f


def linear_warmup_cosine(warmup_steps: int, total_steps: int, min_frac: float = 0.1):
    """Linear 0→1 over warmup, cosine 1→min_frac over the rest."""
    def f(step):
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_frac + (1.0 - min_frac) * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, cos)

    return f
