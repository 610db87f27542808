"""Learning-rate schedules (callables step -> lr): ``step`` is an int32
scalar tensor and the lr a float32 scalar on its device, every step of
the arithmetic in float32 as the JAX package computes it."""
from __future__ import annotations

import math

import torch


def constant_lr(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def inverse_time_lr(alpha: float, beta: float):
    """Paper Thm A.7 schedule: eta_t = alpha / (t + beta)."""
    return lambda step: alpha / (step.float() + beta)


def cosine_lr(base: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return base * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine_lr(base: float, warmup: int, total_steps: int,
                     final_frac: float = 0.1):
    cos = cosine_lr(base, max(1, total_steps - warmup), final_frac)

    def f(step):
        s = step.float()
        warm = base * s / max(1, warmup)
        return torch.where(s < warmup, warm, cos(step - warmup))
    return f
