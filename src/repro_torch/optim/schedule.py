"""Learning-rate schedules (pure functions of the step counter).
Counterpart of ``src/repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int = 100,
                  total_steps: int = 10_000,
                  min_frac: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = peak_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float) -> torch.Tensor:
    del step
    return torch.tensor(peak_lr, dtype=torch.float32)
