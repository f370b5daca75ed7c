"""Learning-rate schedules: pure functions of the step counter, giving a
multiplier on ``AdamWConfig.lr`` as a 0-d float32 tensor on the step's
device.  The port of the JAX package's ``training/schedule.py``."""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["warmup_cosine", "warmup_linear", "constant"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(value: float = 1.0) -> Callable:
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def warmup_cosine(warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    """Linear warmup 0->1 then cosine decay 1->final_frac."""

    def fn(step):
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        t = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * t))
        return torch.where(s < warmup_steps, warm, cos)

    return fn


def warmup_linear(warmup_steps: int, total_steps: int,
                  final_frac: float = 0.0) -> Callable:
    def fn(step):
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        t = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
        lin = 1.0 - (1.0 - final_frac) * torch.clamp(t, 0.0, 1.0)
        return torch.where(s < warmup_steps, warm, lin)

    return fn
