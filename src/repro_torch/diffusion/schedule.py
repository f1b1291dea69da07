"""DDPM noise schedules (port of ``repro.diffusion.schedule``).

The paper (Sec. 5.2.1) uses the exponential VP schedule

    beta_l = 1 - exp( -beta_min/L - (2l-1)/(2 L^2) (beta_max - beta_min) )

for l = 1..L.  Computed in float32 on the CPU, in the JAX op order.  The
``*_host`` tuples hold the same values as Python floats, so the sampler
hands the kernel its scalars without reading a device tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class DiffusionSchedule:
    betas: torch.Tensor        # (L,) float32, CPU
    alphas: torch.Tensor       # (L,)
    alpha_bars: torch.Tensor   # (L,) cumulative products
    beta_tildes: torch.Tensor  # (L,) posterior variances
    alphas_host: Tuple[float, ...]
    alpha_bars_host: Tuple[float, ...]
    beta_tildes_host: Tuple[float, ...]

    @property
    def L(self) -> int:
        return self.betas.shape[0]


def make_schedule(L: int, *, beta_min: float = 0.1, beta_max: float = 10.0,
                  kind: str = "paper") -> DiffusionSchedule:
    f32 = torch.float32
    l = torch.arange(1, L + 1, dtype=f32)
    if kind == "paper":
        betas = 1.0 - torch.exp(-beta_min / L - (2 * l - 1) / (2 * L**2)
                                * (beta_max - beta_min))
    elif kind == "linear":       # Ho et al. DDPM default (image side)
        betas = torch.linspace(1e-4, 0.02, L, dtype=f32)
    elif kind == "cosine":
        s = 0.008
        f = torch.cos((torch.arange(L + 1, dtype=f32) / L + s) / (1 + s)
                      * math.pi / 2) ** 2
        betas = torch.clamp(1.0 - f[1:] / f[:-1], 0.0, 0.999)
    else:
        raise ValueError(kind)
    alphas = 1.0 - betas
    alpha_bars = torch.cumprod(alphas, dim=0)
    prev = torch.cat([torch.ones(1, dtype=f32), alpha_bars[:-1]])
    beta_tildes = (1.0 - prev) / (1.0 - alpha_bars) * betas
    return DiffusionSchedule(betas, alphas, alpha_bars, beta_tildes,
                             tuple(alphas.tolist()),
                             tuple(alpha_bars.tolist()),
                             tuple(beta_tildes.tolist()))
