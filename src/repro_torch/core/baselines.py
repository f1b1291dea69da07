"""Benchmark solutions (paper Sec. 7.2), port of ``repro.core.baselines``:
the static and random caches and the RCARS allocation.

SCHRS' per-slot genetic algorithm waits for ROADMAP queue A item 5; its
configuration is here so ``T2DRLCfg`` keeps the JAX fields.
"""
from __future__ import annotations

import dataclasses

import torch

from .env import EnvCfg, EnvState, ModelParams


@dataclasses.dataclass(frozen=True)
class GACfg:
    pop: int = 40
    gens: int = 40
    eta_c: float = 15.0     # SBX distribution index
    eta_m: float = 20.0     # polynomial-mutation distribution index
    pm: float = 0.08        # per-gene mutation probability
    pc: float = 0.9         # crossover probability


def _greedy_fill(order, c, C: float):
    """Take models in ``order`` (an (M,) index tensor) while they fit into
    C; f32 running sum on the device, as the JAX scan keeps it, and no
    host read."""
    used = torch.zeros((), device=c.device)
    rho = torch.zeros_like(c)
    for i in range(order.shape[0]):
        m = order[i]
        take = (used + c[m]) <= C
        rho[m] = take.to(torch.float32)
        used = used + torch.where(take, c[m], 0.0)
    return rho


def static_popular_cache(models: ModelParams, cfg: EnvCfg) -> torch.Tensor:
    """Cache the most popular models (Zipf rank = model id) greedily until
    the capacity C is exhausted, skipping models that do not fit."""
    return _greedy_fill(torch.arange(cfg.M, device=models.c.device),
                        models.c, cfg.C)


def random_cache(generator: torch.Generator, models: ModelParams,
                 cfg: EnvCfg) -> torch.Tensor:
    """Random-order greedy fill (RCARS)."""
    perm = torch.randperm(cfg.M, generator=generator,
                          device=generator.device)
    return _greedy_fill(perm, models.c, cfg.C)


def rcars_allocate(state: EnvState, cfg: EnvCfg):
    """Equal bandwidth split; compute split equally over cached requests."""
    b = torch.full((cfg.U,), 1.0 / cfg.U, device=state.h.device)
    gate = state.rho[state.req]
    xi = gate / (torch.sum(gate) + 1e-9)
    return b, xi
