"""LR schedules, pure functions of the step (the counterpart of
``repro.optim.schedules``)."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def warmup_cosine(step, base_lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_ratio * base_lr`` at ``total``; a float32 tensor."""
    step = torch.as_tensor(step).float()
    warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, base_lr * cos)


def constant(step, base_lr: float):
    return base_lr
