"""Conditional noise-prediction MLP, the D3PG actor core (port of
``repro.diffusion.denoiser``).

3 hidden layers of 128 learn eps_hat(x_l, l, s): the step index enters
through a sinusoidal time embedding, the state by concatenation, in the
order ``[x, state, te]``.  ``StackedDenoiser`` holds B learners' nets as
one ``StackedMLP`` (the fused vector-env path).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.networks import MLP, StackedMLP, mlp_init, stack_mlps

TIME_DIM = 16


def time_embedding(l, dim: int = TIME_DIM, *, device=None):
    """Sinusoidal embedding of the (integer) denoising step.  l: number or
    tensor of any shape -> (..., dim) float32."""
    l = torch.as_tensor(l, dtype=torch.float32, device=device)
    half = dim // 2
    freqs = torch.exp(-math.log(1000.0)
                      * torch.arange(half, device=l.device) / half)
    ang = l[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class Denoiser(nn.Module):
    """eps_hat = f(x_l, l, s).  ``net`` maps ``A + S + time_dim -> A``."""

    def __init__(self, net: MLP, time_dim: int = TIME_DIM):
        super().__init__()
        self.net = net
        self.time_dim = time_dim

    def forward(self, x, l, state, *, te=None):
        """x: (..., A); l: step number (ignored when the embedding ``te``
        is given); state: (..., S)."""
        if te is None:
            te = time_embedding(l, self.time_dim, device=x.device)
        te = te.expand(x.shape[:-1] + te.shape[-1:])
        return self.net(torch.cat([x, state, te], dim=-1))


def denoiser_init(state_dim: int, action_dim: int, generator: torch.Generator,
                  *, hidden: int = 128, n_layers: int = 3,
                  time_dim: int = TIME_DIM) -> Denoiser:
    dims = ([action_dim + state_dim + time_dim] + [hidden] * n_layers
            + [action_dim])
    return Denoiser(mlp_init(dims, generator), time_dim)


def denoiser_apply(p: Denoiser, x, l, state):
    return p(x, l, state)


class StackedDenoiser(nn.Module):
    """B denoisers of the same widths: ``net`` a ``StackedMLP``; x
    (B, ..., A), state (B, ..., S) -> eps_hat (B, ..., A), one step index
    for the whole stack."""

    def __init__(self, net: StackedMLP, time_dim: int = TIME_DIM):
        super().__init__()
        self.net = net
        self.time_dim = time_dim

    @property
    def learners(self) -> int:
        return self.net.learners

    def forward(self, x, l, state, *, te=None):
        if te is None:
            te = time_embedding(l, self.time_dim, device=x.device)
        te = te.expand(x.shape[:-1] + te.shape[-1:])
        return self.net(torch.cat([x, state, te], dim=-1))

    def learner(self, b: int) -> Denoiser:
        """Learner b's ``Denoiser``, its parameters views of the stack's."""
        return Denoiser(self.net.learner(b), self.time_dim)


def stack_denoisers(ps) -> StackedDenoiser:
    """B denoisers of the same widths -> one ``StackedDenoiser`` (copies)."""
    ps = list(ps)
    return StackedDenoiser(stack_mlps(p.net for p in ps), ps[0].time_dim)


def denoiser_apply_stacked(p: StackedDenoiser, x, l, state):
    """``denoiser_apply`` over B stacked learners: x (B, ..., A), state
    (B, ..., S), l one step for the whole stack."""
    return p(x, l, state)
