"""Short-timescale (per-slot) allocation agents behind the protocol, port
of ``repro.agents.allocators``.

The closures call the numeric cores in ``repro_torch.core.d3pg`` /
``repro_torch.core.baselines`` as they are: the protocol adds dispatch,
not arithmetic.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.baselines import GACfg, ga_allocate, rcars_allocate
from repro_torch.core.d3pg import (D3PGCfg, actor_act, actor_act_stacked,
                                   amend_actions, d3pg_diag_zero, d3pg_init,
                                   d3pg_learner, d3pg_update,
                                   d3pg_update_stacked, make_actor_schedule,
                                   stack_d3pg)
from repro_torch.core.env import EnvCfg
from repro_torch.optim import learner_values

from .base import Agent, no_update

_UPDATE_AUX = ("mask", "lr_actor", "lr_critic")
# one schedule object per config, so the chain's tables (cached per
# schedule and device by the sampler) are built once
actor_schedule = functools.lru_cache(maxsize=16)(make_actor_schedule)


def d3pg_allocator(d3: D3PGCfg, sched=None, diag: bool = False) -> Agent:
    """The paper's D3PG allocator (``actor_kind="mlp"`` recovers DDPG).

    ``act`` runs the actor's chain (one ``ddpm_chain`` launch), adds
    ``step["sigma"]`` times N(0, 1) exploration noise, clips to [0, 1] and
    amends; its draws come from the generator in that order.  ``act`` is
    batch-transparent: one generator serves a (B, S) lockstep batch (the
    shared learner).  ``greedy`` passes ``x_L``/``noises``/``impl``
    through to ``actor_act``.  ``act_stacked`` / ``update_stacked`` run B
    learners with learner b's draws from its own generator in ``act``'s /
    ``update``'s order (one stacked ``ddpm_chain`` launch a slot; one
    update's launches for all B).  ``sched`` overrides the actor's
    schedule (default: derived from ``d3``).  ``diag=True`` builds the
    telemetry variant: the updates return ``d3pg_update(diag=True)``'s
    diagnostics and ``diag_zero(device)`` their zeros."""
    sched = actor_schedule(d3) if sched is None else sched
    U = d3.action_dim // 2

    def act(state, obs, generator, step):
        raw = actor_act(state["actor"], d3, sched, obs.s, generator)
        noise = torch.randn(raw.shape, generator=generator,
                            device=raw.device)
        raw = torch.clamp(raw + step["sigma"] * noise, 0.0, 1.0)
        return amend_actions(raw, obs.env.req, obs.env.rho, U, mask=obs.mask)

    def update(state, batch, generator):
        data = {k: v for k, v in batch.items() if k not in _UPDATE_AUX}
        return d3pg_update(state, d3, sched, data, generator,
                           mask=batch.get("mask"),
                           lr_a=batch.get("lr_actor"),
                           lr_c=batch.get("lr_critic"), diag=diag)

    def greedy(policy, obs, generator=None, **chain):
        raw = actor_act(policy["actor"], d3, sched, obs.s, generator, **chain)
        return amend_actions(raw, obs.env.req, obs.env.rho, U, mask=obs.mask)

    def act_stacked(state, obs, generators, step):
        raw = actor_act_stacked(state["actor"], d3, sched, obs.s, generators)
        noise = torch.stack([torch.randn(raw.shape[1:], generator=g,
                                         device=raw.device)
                             for g in generators])
        sigma = learner_values(step["sigma"], len(generators), raw.device)
        if torch.is_tensor(sigma) and sigma.dim():     # per learner
            sigma = sigma[:, None]
        raw = torch.clamp(raw + sigma * noise, 0.0, 1.0)
        return amend_actions(raw, obs.env.req, obs.env.rho, U, mask=obs.mask)

    def update_stacked(state, batch, generators):
        data = {k: v for k, v in batch.items() if k not in _UPDATE_AUX}
        return d3pg_update_stacked(state, d3, sched, data, generators,
                                   mask=batch.get("mask"),
                                   lr_a=batch.get("lr_actor"),
                                   lr_c=batch.get("lr_critic"), diag=diag)

    return Agent(name="d3pg" if d3.actor_kind == "diffusion" else "ddpg",
                 learns=True, init=lambda g: d3pg_init(d3, g),
                 act=act, update=update,
                 export=lambda state: {"actor": state["actor"]},
                 greedy=greedy, act_stacked=act_stacked,
                 update_stacked=update_stacked, stack=stack_d3pg,
                 learner=d3pg_learner,
                 diag_zero=((lambda device=None: d3pg_diag_zero(d3, device))
                            if diag else None))


def schrs_allocator(env_cfg: EnvCfg, ga: GACfg) -> Agent:
    """SCHRS' per-slot genetic algorithm (no learned state).  ``act`` and
    ``greedy`` evolve one cell's population from the generator;
    ``batch_act`` evolves B cells' populations in lockstep as one
    (B, P, 2U) population with every draw from the one generator;
    ``act_stacked`` does the same with cell b's draws from its own
    generator, as ``act`` draws them."""

    def act(state, obs, generator, step):
        return ga_allocate(generator, obs.env, env_cfg, obs.models, ga)

    def act_stacked(state, obs, generators, step):
        return ga_allocate(list(generators), obs.env, env_cfg, obs.models,
                           ga)

    return Agent(name="schrs", learns=False, init=lambda g: {}, act=act,
                 update=no_update, export=lambda state: {},
                 greedy=lambda policy, obs, generator=None, **_:
                 ga_allocate(generator, obs.env, env_cfg, obs.models, ga),
                 batch_act=act, act_stacked=act_stacked)


def rcars_allocator(env_cfg: EnvCfg) -> Agent:
    """RCARS equal-split allocation (deterministic, draws nothing)."""

    def act(state, obs, generator, step):
        return rcars_allocate(obs.env, env_cfg)

    return Agent(name="rcars", learns=False, init=lambda g: {}, act=act,
                 update=no_update, export=lambda state: {},
                 greedy=lambda policy, obs, generator=None, **_:
                 rcars_allocate(obs.env, env_cfg),
                 batch_act=act, act_stacked=act)


ALLOCATORS = ("d3pg", "ddpg", "schrs", "rcars")


def make_allocator(kind: str, env_cfg: EnvCfg, d3: D3PGCfg,
                   ga: GACfg = GACfg(), diag: bool = False) -> Agent:
    """Dispatch an allocator name to its Agent bundle — the only place
    allocator kinds are branched on (DESIGN.md §12).  ``diag`` builds the
    learned allocators' telemetry variant (no-op for the others)."""
    if kind in ("d3pg", "ddpg"):
        return d3pg_allocator(d3, diag=diag)
    if kind == "schrs":
        return schrs_allocator(env_cfg, ga)
    if kind == "rcars":
        return rcars_allocator(env_cfg)
    raise ValueError(f"unknown allocator {kind!r}; expected one of "
                     f"{ALLOCATORS}")
