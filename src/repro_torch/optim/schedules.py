"""Learning-rate schedules (warmup + cosine), evaluated in f32 like the
reference's `repro/optim/schedules.py`."""

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
