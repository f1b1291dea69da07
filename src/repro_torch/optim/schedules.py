"""Learning-rate schedules, callable on an integer step (port of
``repro.optim.schedules``); each returns a 0-dim f32 tensor."""
from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(lr: float, steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1.0 - final_frac) * cos)
    return f


def linear_warmup_cosine(lr: float, warmup: int, steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(steps - warmup, 1), final_frac)

    def f(step):
        step = torch.as_tensor(step)
        w = torch.clamp(_f32(step) / max(warmup, 1), max=1.0)
        return w * cos(torch.clamp(step - warmup, min=0))
    return f
