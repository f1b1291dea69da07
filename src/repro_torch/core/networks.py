"""Plain MLPs for the denoiser and Q networks (paper Sec. 7.1 topology).

Weights keep the JAX layout — ``w: (in, out)``, ``b: (out,)``, applied as
``x @ w + b`` — so trees cross over from ``repro.core.networks`` as they
are (:mod:`repro_torch.bridge`).
"""
from __future__ import annotations

import math

import torch
from torch import nn


class MLP(nn.Module):
    """ReLU between layers, none after the last (``mlp_apply``)."""

    def __init__(self, ws, bs):
        super().__init__()
        self.w = nn.ParameterList(nn.Parameter(w) for w in ws)
        self.b = nn.ParameterList(nn.Parameter(b) for b in bs)

    def forward(self, x, final_act=None):
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1:
                x = torch.relu(x)
        return x if final_act is None else final_act(x)


def mlp_init(dims, generator: torch.Generator) -> MLP:
    """``w ~ N(0, 1/in)``, zero bias (the JAX init distribution), drawn on
    the generator's device."""
    dev = generator.device
    ws = [torch.randn(i, o, generator=generator, device=dev) / math.sqrt(i)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros(o, device=dev) for o in dims[1:]]
    return MLP(ws, bs)


def mlp_apply(mlp: MLP, x, *, final_act=None):
    return mlp(x, final_act=final_act)


@torch.no_grad()
def soft_update(target: nn.Module, online: nn.Module, rate: float):
    """Polyak averaging, Eqs. (28)-(29)/(35): ``target <- target +
    rate * (online - target)``, in place (one ``lerp`` over every
    parameter); returns ``target``."""
    torch._foreach_lerp_(list(target.parameters()),
                         list(online.parameters()), rate)
    return target
