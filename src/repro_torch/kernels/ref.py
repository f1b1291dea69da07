"""Plain PyTorch versions of the hand-written kernels.

Each repeats its kernel's arithmetic op for op, so on the card the two
agree bit for bit; the CPU tests and ``chip_smoke.py`` hold the kernels
against these.
"""
from __future__ import annotations

import torch


def ddpm_step_ref(x, eps_hat, noise, c1: float, c2: float, sigma: float):
    """One fused reverse-diffusion update (Eqs. 19-20) with the scalars
    precomputed: ``x' = c1*x - c2*eps_hat + sigma*noise``, in f32, cast
    back to ``x.dtype``.  See ``ops.ddpm_coefficients`` for c1, c2, sigma."""
    xf, ef, nf = x.float(), eps_hat.float(), noise.float()
    return (c1 * xf - c2 * ef + sigma * nf).to(x.dtype)
