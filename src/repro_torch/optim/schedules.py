"""LR schedules: pure functions of the step counter, as in
``repro.optim.schedules``.  Each takes the step (an int or an integer
tensor) and returns a float32 scalar tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def warmup_linear(lr: float, warmup: int, total: int):
    def f(step):
        step = _f32(step)
        wu = torch.clamp(step / max(warmup, 1), max=1.0)
        decay = torch.clamp(1.0 - (step - warmup) / max(total - warmup, 1),
                            min=0.0)
        return lr * wu * torch.where(step < warmup, 1.0, decay)
    return f


def warmup_cosine(lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    def f(step):
        step = _f32(step)
        wu = torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return lr * wu * torch.where(step < warmup, 1.0, cos)
    return f
