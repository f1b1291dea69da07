"""Short-timescale (per-slot) allocation agents behind the protocol, port
of ``repro.agents.allocators``.

The closures call the numeric cores in ``repro_torch.core.d3pg`` /
``repro_torch.core.baselines`` as they are: the protocol adds dispatch,
not arithmetic.  SCHRS (the per-slot genetic algorithm) waits for ROADMAP
A.5.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.baselines import GACfg, rcars_allocate
from repro_torch.core.d3pg import (D3PGCfg, actor_act, amend_actions,
                                   d3pg_init, d3pg_update,
                                   make_actor_schedule)
from repro_torch.core.env import EnvCfg

from .base import Agent, no_update

_UPDATE_AUX = ("mask", "lr_actor", "lr_critic")
# one schedule object per config, so the chain's tables (cached per
# schedule and device by the sampler) are built once
actor_schedule = functools.lru_cache(maxsize=16)(make_actor_schedule)


def d3pg_allocator(d3: D3PGCfg) -> Agent:
    """The paper's D3PG allocator (``actor_kind="mlp"`` recovers DDPG).

    ``act`` runs the actor's chain (one ``ddpm_chain`` launch), adds
    ``step["sigma"]`` times N(0, 1) exploration noise, clips to [0, 1] and
    amends; its draws come from the generator in that order.  ``greedy``
    passes ``x_L``/``noises``/``impl`` through to ``actor_act``."""
    sched = actor_schedule(d3)
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
                           lr_c=batch.get("lr_critic"))

    def greedy(policy, obs, generator=None, **chain):
        raw = actor_act(policy["actor"], d3, sched, obs.s, generator, **chain)
        return amend_actions(raw, obs.env.req, obs.env.rho, U, mask=obs.mask)

    return Agent(name="d3pg" if d3.actor_kind == "diffusion" else "ddpg",
                 learns=True, init=lambda g: d3pg_init(d3, g),
                 act=act, update=update,
                 export=lambda state: {"actor": state["actor"]},
                 greedy=greedy)


def rcars_allocator(env_cfg: EnvCfg) -> Agent:
    """RCARS equal-split allocation (deterministic, draws nothing)."""

    def act(state, obs, generator, step):
        return rcars_allocate(obs.env, env_cfg)

    return Agent(name="rcars", learns=False, init=lambda g: {}, act=act,
                 update=no_update, export=lambda state: {},
                 greedy=lambda policy, obs, generator=None, **_:
                 rcars_allocate(obs.env, env_cfg))


ALLOCATORS = ("d3pg", "ddpg", "schrs", "rcars")


def make_allocator(kind: str, env_cfg: EnvCfg, d3: D3PGCfg,
                   ga: GACfg = GACfg()) -> Agent:
    """Dispatch an allocator name to its Agent bundle — the only place
    allocator kinds are branched on (DESIGN.md §12)."""
    if kind in ("d3pg", "ddpg"):
        return d3pg_allocator(d3)
    if kind == "schrs":
        raise NotImplementedError("'schrs' is not ported yet: the SCHRS "
                                  "genetic allocator (ROADMAP queue A, "
                                  "item 5)")
    if kind == "rcars":
        return rcars_allocator(env_cfg)
    raise ValueError(f"unknown allocator {kind!r}; expected one of "
                     f"{ALLOCATORS}")
