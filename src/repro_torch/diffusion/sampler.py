"""Reverse-process sampling (Eqs. 17-20), the D3PG action generator and
the gateway's image chain (port of ``repro.diffusion.sampler``).

Starting from x_L ~ N(0, I), iterate

    x_{l-1} = c1_l x_l - c2_l eps_hat(x_l, l, s) + sigma_l eps,   eps ~ N(0, I)

with sigma_1 = 0.  Every step goes through ``kernels.ops.ddpm_step``: the
hand-written kernel on the card, its plain version on the CPU.  Inference
only — the chain runs under ``torch.no_grad`` (the kernel's backward comes
with the training slice).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

from .denoiser import Denoiser, time_embedding
from .schedule import DiffusionSchedule


@torch.no_grad()
def reverse_sample(p: Denoiser, sched: DiffusionSchedule, state,
                   action_dim: int, *, generator=None, x_L=None,
                   noises=None):
    """One reverse chain.  state: (..., S) -> x0: (..., A) in [-1, 1].

    ``x_L`` (shape ``(..., A)``) and ``noises`` (``(L, ..., A)``, consumed
    in chain order, ``noises[0]`` at the first step) may be injected;
    otherwise they are drawn from ``generator`` on ``state``'s device."""
    L = sched.L
    shape = state.shape[:-1] + (action_dim,)
    dev = state.device
    if x_L is None:
        x_L = torch.randn(shape, generator=generator, device=dev)
    if noises is None:
        noises = torch.randn((L,) + shape, generator=generator, device=dev)
    te = time_embedding(torch.arange(1, L + 1, device=dev), p.time_dim)
    x = x_L
    for i in range(L):
        l_rev = L - 1 - i          # 0-based step index, L-1 .. 0
        eps_hat = p(x, None, state, te=te[l_rev])
        x = kops.ddpm_step(x, eps_hat, noises[i], sched.alphas_host[l_rev],
                           sched.alpha_bars_host[l_rev],
                           sched.beta_tildes_host[l_rev], l_rev)
    return torch.tanh(x)


def reverse_sample_actions(p: Denoiser, sched: DiffusionSchedule, state,
                           action_dim: int, *, generator=None, x_L=None,
                           noises=None):
    """Action in [0, 1]^A (the paper's raw action range)."""
    x0 = reverse_sample(p, sched, state, action_dim, generator=generator,
                        x_L=x_L, noises=noises)
    return 0.5 * (x0 + 1.0)
