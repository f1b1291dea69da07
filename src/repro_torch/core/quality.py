"""Fitted AIGC service models (paper Sec. 3.4, Fig. 3), port of
``repro.core.quality``.

Eq. (7): piecewise-linear TV quality vs. denoising steps (A1 steps where
quality starts improving, A2 worst TV, A3 steps where it saturates, A4 best
TV; lower is better).  Eq. (8): generation delay B1*steps + B2.
"""
from __future__ import annotations

import torch

# Paper's fitted constants (RePaint / CelebA-HQ, Fig. 3)
A1, A2, A3, A4 = 60.0, 110.0, 170.0, 28.0
B1, B2 = 0.18, 5.74


def tv_quality(steps, a1=A1, a2=A2, a3=A3, a4=A4):
    """Eq. (7): TV after ``steps`` denoising steps (tensor); the curve
    parameters broadcast (floats or per-model tensors)."""
    slope = (a4 - a2) / (a3 - a1)
    mid = a2 + slope * (steps - a1)
    return torch.where(steps <= a1, a2, torch.where(steps >= a3, a4, mid))


def gen_delay(steps, b1=B1, b2=B2):
    """Eq. (8): image generation time for ``steps`` denoising steps."""
    return b1 * steps + b2


def cloud_quality(a4=A4):
    """Un-cached requests go to the cloud: best quality (Sec. 3.4.1)."""
    return a4


def cloud_delay(a3=A3, b1=B1, b2=B2):
    """Cloud allocates the minimum steps reaching best quality (3.4.2)."""
    return b1 * a3 + b2
