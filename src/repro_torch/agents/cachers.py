"""Long-timescale (per-frame) caching agents behind the protocol, port of
``repro.agents.cachers``.

Cacher ``act`` returns ``(a_int, rho)``: the raw integer action (what the
DDQN's frame transition stores) and the amended caching vector.  The
closures call ``repro_torch.core.ddqn`` / ``repro_torch.core.baselines``
as they are.  The classical cache-hierarchy cachers (LRU, LFU, ghost-LRU,
ARC) wait for ROADMAP A.7.
"""
from __future__ import annotations

import torch

from repro_torch.core.baselines import random_cache, static_popular_cache
from repro_torch.core.ddqn import (DDQNCfg, amend_caching, ddqn_act,
                                   ddqn_act_stacked, ddqn_init, ddqn_learner,
                                   ddqn_update, ddqn_update_stacked,
                                   stack_ddqn)
from repro_torch.core.env import EnvCfg

from .base import Agent, cell_of, no_update

CACHE_POLICIES = ("lru", "lfu", "lru-ghost", "arc")


def ddqn_cacher(dq: DDQNCfg, env_cfg: EnvCfg) -> Agent:
    """The paper's DDQN cacher over the 2^M caching actions; ``act`` is
    epsilon-greedy at ``step["eps"]`` and batch-transparent in its draw (one
    generator serves B cells' popularity states, ``batch_act``);
    ``act_stacked``/``update_stacked`` run B stacked learners."""

    def act(state, obs, generator, step):
        a_int = ddqn_act(state, dq, obs.gamma_idx, generator, step["eps"])
        return a_int, amend_caching(a_int, dq, obs.models.c, env_cfg.C)

    def update(state, batch, generator):
        data = {k: v for k, v in batch.items() if k != "lr"}
        new, loss = ddqn_update(state, dq, data, lr=batch.get("lr"))
        return new, {"loss": loss}

    def greedy(policy, obs, generator=None):
        a_int = ddqn_act(policy["ddqn"], dq, obs.gamma_idx)
        return amend_caching(a_int, dq, obs.models.c, env_cfg.C)

    def act_stacked(state, obs, generators, step):
        a_int = ddqn_act_stacked(state, dq, obs.gamma_idx, generators,
                                 step["eps"])
        return a_int, amend_caching(a_int, dq, obs.models.c, env_cfg.C)

    def update_stacked(state, batch, generators):
        data = {k: v for k, v in batch.items() if k != "lr"}
        new, loss = ddqn_update_stacked(state, dq, data, lr=batch.get("lr"))
        return new, {"loss": loss}

    return Agent(name="ddqn", learns=True, init=lambda g: ddqn_init(dq, g),
                 act=act, update=update,
                 export=lambda state: {"ddqn": {"q": state["q"]}},
                 greedy=greedy, batch_act=act, act_stacked=act_stacked,
                 update_stacked=update_stacked, stack=stack_ddqn,
                 learner=ddqn_learner)


def _per_cell(fn, B: int):
    """(a_int, rho) of B cells from ``fn(b)`` -> rho, one cell at a time,
    stacked, with zero actions."""
    rhos = [fn(b) for b in range(B)]
    rho = torch.stack(rhos)
    return torch.zeros(B, dtype=torch.int64, device=rho.device), rho


def _zero_action(models):
    return torch.zeros((), dtype=torch.int64, device=models.c.device)


def static_cacher(env_cfg: EnvCfg) -> Agent:
    """SCHRS static caching: most-popular models greedily to capacity."""

    def act(state, obs, generator, step):
        return (_zero_action(obs.models),
                static_popular_cache(obs.models, env_cfg))

    def batch_act(state, obs, generator, step):
        return _per_cell(lambda b: static_popular_cache(
            cell_of(obs.models, b), env_cfg), obs.gamma_idx.shape[0])

    return Agent(name="static", learns=False, init=lambda g: {}, act=act,
                 update=no_update, export=lambda state: {},
                 greedy=lambda policy, obs, generator=None:
                 static_popular_cache(obs.models, env_cfg),
                 batch_act=batch_act, act_stacked=batch_act)


def random_cacher(env_cfg: EnvCfg) -> Agent:
    """RCARS random caching: random-order greedy fill from the generator;
    B cells in lockstep draw their orders from the one generator in cell
    order (``batch_act``), or cell b's from its own (``act_stacked``)."""

    def act(state, obs, generator, step):
        return (_zero_action(obs.models),
                random_cache(generator, obs.models, env_cfg))

    def batch_act(state, obs, generator, step):
        return _per_cell(lambda b: random_cache(
            generator, cell_of(obs.models, b), env_cfg),
            obs.gamma_idx.shape[0])

    def act_stacked(state, obs, generators, step):
        return _per_cell(lambda b: random_cache(
            generators[b], cell_of(obs.models, b), env_cfg),
            len(generators))

    return Agent(name="random", learns=False, init=lambda g: {}, act=act,
                 update=no_update, export=lambda state: {},
                 greedy=lambda policy, obs, generator=None:
                 random_cache(generator, obs.models, env_cfg),
                 batch_act=batch_act, act_stacked=act_stacked)


CACHERS = ("ddqn", "static", "random") + CACHE_POLICIES


def make_cacher(kind: str, dq: DDQNCfg, env_cfg: EnvCfg) -> Agent:
    """Dispatch a cacher name to its Agent bundle — the only place cacher
    kinds are branched on (DESIGN.md §12)."""
    if kind == "ddqn":
        return ddqn_cacher(dq, env_cfg)
    if kind == "static":
        return static_cacher(env_cfg)
    if kind == "random":
        return random_cacher(env_cfg)
    if kind in CACHE_POLICIES:
        raise NotImplementedError(f"{kind!r} is not ported yet: the "
                                  "classical cachers (ROADMAP queue A, "
                                  "item 7)")
    raise ValueError(f"unknown cacher {kind!r}; expected one of {CACHERS}")
