"""LR schedules: linear warmup + {linear, cosine, constant} decay.

The same fp32 arithmetic as the reference's ``make_schedule``: the value
is a 0-d fp32 tensor on the step's device (the CPU for a Python int)."""
from __future__ import annotations

import math

import torch


def make_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                  kind: str = "linear", min_frac: float = 0.05):
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        if kind == "cosine":
            decay = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(
                math.pi * frac))
        elif kind == "constant":
            decay = 1.0
        else:  # linear (paper's in-between-pruning schedule)
            decay = 1.0 - (1 - min_frac) * frac
        return base_lr * warm * decay

    return schedule
