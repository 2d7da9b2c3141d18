"""Learning-rate schedules (warmup + cosine/linear; large-batch friendly),
evaluated in f32 like the reference's `repro/optim/schedules.py`."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = torch.tensor(step, dtype=torch.float32)
        if step < warmup_steps:
            return peak * (step + 1) / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return peak * (final_frac + (1 - final_frac)
                       * 0.5 * (1 + torch.cos(math.pi * t)))
    return fn


def warmup_linear(peak: float, warmup_steps: int, total_steps: int):
    def fn(step):
        step = torch.tensor(step, dtype=torch.float32)
        if step < warmup_steps:
            return peak * (step + 1) / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return peak * (1 - t)
    return fn


def linear_batch_scaled(base_lr: float, base_batch: int, batch: int):
    """Goyal et al.'s linear scaling rule: the learning rate grows with the
    global batch (the optimizer's half of the large-batch argument)."""
    return base_lr * batch / base_batch
