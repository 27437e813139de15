"""LR schedules as functions of the step counter (port of
``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step, *, peak_lr: float, warmup: int = 100,
                  total: int = 10_000, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor`` times
    it; a 0-d f32 tensor on ``step``'s device, computed in f32 in the
    reference's order."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
