"""Benchmark solutions (paper Sec. 7.2), port of ``repro.core.baselines``.

SCHRS — static caching (most popular models under gamma_1 = 0.2, greedy
fill to capacity) + a per-slot genetic algorithm over allocation
chromosomes with simulated-binary crossover (SBX) and polynomial mutation
(``ga_allocate``).

RCARS — random caching to capacity + equal bandwidth / compute split.
"""
from __future__ import annotations

import dataclasses

import torch

from .d3pg import amend_actions
from .env import (EnvCfg, EnvState, ModelParams, _take, slot_metrics)


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


def _zoo_cell(models: ModelParams, b: int) -> ModelParams:
    return ModelParams(*(f[b] for f in models))


def static_popular_cache_batch(models: ModelParams,
                               cfg: EnvCfg) -> torch.Tensor:
    """Per-cell SCHRS caching of a zoo with a leading (B,) axis: (B, M)."""
    return torch.stack([static_popular_cache(_zoo_cell(models, b), cfg)
                        for b in range(models.c.shape[0])])


def random_cache_batch(generators, models: ModelParams,
                       cfg: EnvCfg) -> torch.Tensor:
    """Per-cell RCARS caching of a (B,)-leading zoo, cell b's order drawn
    from ``generators[b]`` (the one generator listed B times draws the
    cells' orders in cell order): (B, M)."""
    return torch.stack([random_cache(g, _zoo_cell(models, b), cfg)
                        for b, g in enumerate(generators)])


def rcars_allocate(state: EnvState, cfg: EnvCfg):
    """Equal bandwidth split; compute split equally over cached requests.
    Leading cell axes of ``state`` carry through."""
    b = torch.full(state.req.shape, 1.0 / cfg.U, device=state.h.device)
    gate = _take(state.rho, state.req)
    xi = gate / (torch.sum(gate, dim=-1, keepdim=True) + 1e-9)
    return b, xi


# -- SCHRS genetic algorithm --------------------------------------------------

def _sbx(u, p1, p2, eta: float):
    """Simulated-binary crossover of parent rows p1, p2 on the uniforms
    ``u`` (their shape); children clipped to [0, 1]."""
    e = 1.0 / (eta + 1.0)
    beta = torch.where(u <= 0.5, (2.0 * u) ** e,
                       (1.0 / (2.0 * (1.0 - u) + 1e-12)) ** e)
    c1 = 0.5 * ((1 + beta) * p1 + (1 - beta) * p2)
    c2 = 0.5 * ((1 - beta) * p1 + (1 + beta) * p2)
    return torch.clamp(c1, 0.0, 1.0), torch.clamp(c2, 0.0, 1.0)


def _poly_mutation(u, mutate, x, eta: float):
    """Polynomial mutation of x on the uniforms ``u``, where the boolean
    ``mutate`` is set; clipped to [0, 1]."""
    e = 1.0 / (eta + 1.0)
    delta = torch.where(u < 0.5, (2.0 * u) ** e - 1.0,
                        1.0 - (2.0 * (1.0 - u)) ** e)
    return torch.clamp(x + torch.where(mutate, delta, 0.0), 0.0, 1.0)


def ga_draws(generator, ga: GACfg, U: int, lead=(), device=None) -> dict:
    """Every draw of one ``ga_allocate`` call, in the order it is made:
    ``pop`` the initial population's uniforms (P, 2U) (row 0 is replaced
    by the warm start), then for all G generations at once ``idx`` the
    binary-tournament indices (G, 2, P), ``sbx`` the crossover uniforms
    (G, P/2, 2U), ``cx`` the uniforms deciding crossover (G, P/2, 1),
    ``mut`` the mutation uniforms (G, P, 2U) and ``mutate`` its mask
    (G, P, 2U), uniforms below ``ga.pm``.  ``generator``: one generator
    (with ``lead`` = (B,), every draw is made for all B cells at once), or
    a sequence of B generators, cell b's draws from its own as a single
    cell's are drawn (then stacked)."""
    P, G, A = ga.pop, ga.gens, 2 * U
    shapes = {"pop": (P, A), "idx": (G, 2, P), "sbx": (G, P // 2, A),
              "cx": (G, P // 2, 1), "mut": (G, P, A), "mutate": (G, P, A)}
    gens = (list(generator) if isinstance(generator, (list, tuple))
            else None)

    def draw(k, shape):
        if gens is not None:
            return torch.stack([draw_one(k, shape, g, ()) for g in gens])
        return draw_one(k, shape, generator, tuple(lead))

    def draw_one(k, shape, g, lead):
        if k == "idx":
            return torch.randint(0, P, lead + shape, generator=g,
                                 device=g.device)
        u = torch.rand(lead + shape, generator=g, device=g.device)
        return u < ga.pm if k == "mutate" else u

    return {k: draw(k, shape) for k, shape in shapes.items()}


def _ga_view(state: EnvState, models: ModelParams, batched: bool):
    """The state and zoo with a population axis before the user/model
    axis (cells keep their leading axis), so fitness broadcasts over P."""
    if not batched:
        return state, models
    return (state._replace(**{f: getattr(state, f)[:, None]
                              for f in ("req", "rho", "h", "d_in")}),
            ModelParams(*(t[:, None] for t in models)))


def ga_allocate(generator, state: EnvState, cfg: EnvCfg,
                models: ModelParams, ga: GACfg = GACfg(), *, draws=None):
    """Evolve allocation chromosomes for the current slot; returns the
    amended (b, xi) of the fittest.

    Fitness is the slot objective (12) plus the deadline penalty of (23),
    the mean over all U users; lower is better.  The population starts
    from uniforms with row 0 the all-0.5 warm start (which amends to the
    equal split), and each of ``ga.gens`` generations does a binary
    tournament, SBX on consecutive pairs (with probability ``ga.pc``),
    polynomial mutation, and keeps the best individual so far in row 0, so
    the result is never less fit than the warm start.  The population axis
    is batched: a generation scores all P chromosomes (of all cells) in one
    pass through ``amend_actions`` and ``slot_metrics``; the generations
    are a host loop.

    ``state``/``models`` are one cell's, or B cells' (leading (B,) axes;
    then B independent populations, (B, P, 2U), in lockstep).  ``draws``
    (``ga_draws``' keys and shapes, with the leading (B,) of the cells)
    injects every random draw; otherwise they are drawn from ``generator``
    as ``ga_draws`` draws them (one generator, or B of them)."""
    U = cfg.U
    batched = state.rho.dim() == 2
    lead = (state.rho.shape[0],) if batched else ()
    if draws is None:
        draws = ga_draws(generator, ga, U, lead)
    st, mp = _ga_view(state, models, batched)

    def fitness(chrom):
        b, xi = amend_actions(chrom, st.req, st.rho, U)
        m = slot_metrics(st, cfg, mp, b, xi)
        viol = (m["d_tl"] > cfg.tau).to(torch.float32)
        return torch.mean(m["G"] + viol * cfg.chi, dim=-1)

    def rows(x, idx):                   # x[..., idx, :] per cell
        return torch.gather(x, -2, idx[..., None].expand(
            idx.shape + x.shape[-1:]))

    pop = draws["pop"].clone()
    pop[..., 0, :] = 0.5                # warm start: the equal split
    fit = fitness(pop)
    for gi in range(ga.gens):
        idx = draws["idx"][..., gi, :, :]
        f0 = torch.gather(fit, -1, idx[..., 0, :])
        f1 = torch.gather(fit, -1, idx[..., 1, :])
        winners = torch.where((f0 < f1)[..., None], rows(pop, idx[..., 0, :]),
                              rows(pop, idx[..., 1, :]))
        p1, p2 = winners[..., 0::2, :], winners[..., 1::2, :]
        c1, c2 = _sbx(draws["sbx"][..., gi, :, :], p1, p2, ga.eta_c)
        do_cx = draws["cx"][..., gi, :, :] < ga.pc
        c1 = torch.where(do_cx, c1, p1)
        c2 = torch.where(do_cx, c2, p2)
        children = _poly_mutation(draws["mut"][..., gi, :, :],
                                  draws["mutate"][..., gi, :, :],
                                  torch.cat([c1, c2], dim=-2), ga.eta_m)
        child_fit = fitness(children)
        # elitism: the best individual so far replaces child 0
        best = torch.argmin(fit, dim=-1, keepdim=True)
        children[..., 0:1, :] = rows(pop, best)
        child_fit[..., 0:1] = torch.gather(fit, -1, best)
        pop, fit = children, child_fit
    best = rows(pop, torch.argmin(fit, dim=-1, keepdim=True))[..., 0, :]
    return amend_actions(best, state.req, state.rho, U)
