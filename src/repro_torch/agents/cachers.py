"""Long-timescale (per-frame) caching agents behind the protocol, port of
``repro.agents.cachers``.

Cacher ``act`` returns ``(a_int, rho)``: the raw integer action (what the
DDQN's frame transition stores) and the amended caching vector.  The
closures call ``repro_torch.core.ddqn`` / ``repro_torch.core.baselines``
as they are.

Beyond the paper's ddqn/static/random triple, :func:`classical_cacher`
gives the adaptive cache-hierarchy baselines of DESIGN.md §14 (LRU, LFU,
ghost-LRU and ARC from ``repro_torch.core.cache_policies``) as stateful,
non-learned agents: ``act`` snapshots the resident set as the frame's
caching vector, and ``step_frame`` replays the frame's requests through
the state machine afterwards, so the cache that serves frame t reflects
the requests of frames < t.
"""
from __future__ import annotations

import torch

from repro_torch.core.baselines import (random_cache, random_cache_batch,
                                        static_popular_cache,
                                        static_popular_cache_batch)
from repro_torch.core.cache_policies import (CACHE_POLICIES, cache_access,
                                             cache_rho, cache_state_init,
                                             quantize_capacity,
                                             quantize_sizes)
from repro_torch.core.ddqn import (DDQNCfg, amend_caching, ddqn_act,
                                   ddqn_act_stacked, ddqn_diag_zero,
                                   ddqn_init, ddqn_learner, ddqn_update,
                                   ddqn_update_stacked, stack_ddqn)
from repro_torch.core.env import EnvCfg

from .base import Agent, no_update


def ddqn_cacher(dq: DDQNCfg, env_cfg: EnvCfg, diag: bool = False) -> Agent:
    """The paper's DDQN cacher over the 2^M caching actions; ``act`` is
    epsilon-greedy at ``step["eps"]`` and batch-transparent in its draw (one
    generator serves B cells' popularity states, ``batch_act``);
    ``act_stacked``/``update_stacked`` run B stacked learners.
    ``diag=True``: the updates return ``ddqn_update(diag=True)``'s
    diagnostics and ``diag_zero(device)`` their zeros."""

    def act(state, obs, generator, step):
        a_int = ddqn_act(state, dq, obs.gamma_idx, generator, step["eps"])
        return a_int, amend_caching(a_int, dq, obs.models.c, env_cfg.C)

    def update(state, batch, generator):
        data = {k: v for k, v in batch.items() if k != "lr"}
        new, m = ddqn_update(state, dq, data, lr=batch.get("lr"), diag=diag)
        return new, (m if diag else {"loss": m})

    def greedy(policy, obs, generator=None):
        a_int = ddqn_act(policy["ddqn"], dq, obs.gamma_idx)
        return amend_caching(a_int, dq, obs.models.c, env_cfg.C)

    def act_stacked(state, obs, generators, step):
        a_int = ddqn_act_stacked(state, dq, obs.gamma_idx, generators,
                                 step["eps"])
        return a_int, amend_caching(a_int, dq, obs.models.c, env_cfg.C)

    def update_stacked(state, batch, generators):
        data = {k: v for k, v in batch.items() if k != "lr"}
        new, m = ddqn_update_stacked(state, dq, data, lr=batch.get("lr"),
                                     diag=diag)
        return new, (m if diag else {"loss": m})

    return Agent(name="ddqn", learns=True, init=lambda g: ddqn_init(dq, g),
                 act=act, update=update,
                 export=lambda state: {"ddqn": {"q": state["q"]}},
                 greedy=greedy, batch_act=act, act_stacked=act_stacked,
                 update_stacked=update_stacked, stack=stack_ddqn,
                 learner=ddqn_learner,
                 diag_zero=((lambda device=None: ddqn_diag_zero(dq, device))
                            if diag else None))


def _zero_actions(rho):
    """(a_int, rho) of B cells: zero actions beside the (B, M) rho."""
    return torch.zeros(rho.shape[0], dtype=torch.int64,
                       device=rho.device), rho


def _zero_action(models):
    return torch.zeros((), dtype=torch.int64, device=models.c.device)


def static_cacher(env_cfg: EnvCfg) -> Agent:
    """SCHRS static caching: most-popular models greedily to capacity."""

    def act(state, obs, generator, step):
        return (_zero_action(obs.models),
                static_popular_cache(obs.models, env_cfg))

    def batch_act(state, obs, generator, step):
        return _zero_actions(static_popular_cache_batch(obs.models,
                                                        env_cfg))

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
        return _zero_actions(random_cache_batch(
            [generator] * obs.gamma_idx.shape[0], obs.models, env_cfg))

    def act_stacked(state, obs, generators, step):
        return _zero_actions(random_cache_batch(generators, obs.models,
                                                env_cfg))

    return Agent(name="random", learns=False, init=lambda g: {}, act=act,
                 update=no_update, export=lambda state: {},
                 greedy=lambda policy, obs, generator=None:
                 random_cache(generator, obs.models, env_cfg),
                 batch_act=batch_act, act_stacked=act_stacked)


def classical_cacher(kind: str, env_cfg: EnvCfg) -> Agent:
    """A classical cache-hierarchy baseline (DESIGN.md §14) as an Agent.

    Its state is the ``cache_policies`` state machine, which the loop
    threads through the train state's ``"cache"`` slot (``init`` takes
    the generator's device and draws nothing).  ``act`` is a snapshot:
    zero actions and ``cache_rho(state)``; every state op is elementwise
    over the trailing (M,) axis, so one ``act`` serves B cells' (B, M)
    states (``batch_act``, ``act_stacked``).  ``step_frame(state, reqs,
    models, mask)`` replays the frame's (..., K, U) requests row-major
    (slot 0's users first, users in index order), inactive users
    (``mask`` 0) as no-op accesses: K*U accesses a frame, the same
    launches for one cell or B."""
    if kind not in CACHE_POLICIES:
        raise ValueError(f"unknown cache policy {kind!r}; expected one of "
                         f"{CACHE_POLICIES}")
    cap_units = quantize_capacity(env_cfg.C)

    def act(state, obs, generator, step):
        a_int = torch.zeros(obs.gamma_idx.shape, dtype=torch.int64,
                            device=obs.gamma_idx.device)
        return a_int, cache_rho(state)

    def step_frame(state, reqs, models, mask):
        c_units = quantize_sizes(models.c)
        lead = tuple(reqs.shape[:-2])
        stream = reqs.reshape(lead + (-1,))               # (..., K*U)
        valid = (None if mask is None
                 else mask.to(torch.bool).repeat(
                     (1,) * len(lead) + (reqs.shape[-2],)))
        for i in range(stream.shape[-1]):
            state, _ = cache_access(kind, state, stream[..., i], c_units,
                                    cap_units,
                                    None if valid is None else valid[..., i])
        return state

    return Agent(name=kind, learns=False,
                 init=lambda g: cache_state_init(env_cfg.M, g.device),
                 act=act, update=no_update,
                 export=lambda state: {"cache": {"rho": cache_rho(state)}},
                 greedy=lambda policy, obs, generator=None:
                 policy["cache"]["rho"],
                 step_frame=step_frame, batch_act=act, act_stacked=act)


CACHERS = ("ddqn", "static", "random") + CACHE_POLICIES


def make_cacher(kind: str, dq: DDQNCfg, env_cfg: EnvCfg,
                diag: bool = False) -> Agent:
    """Dispatch a cacher name to its Agent bundle — the only place cacher
    kinds are branched on (DESIGN.md §12).  ``diag`` builds the DDQN's
    telemetry variant (no-op for the non-learned cachers)."""
    if kind == "ddqn":
        return ddqn_cacher(dq, env_cfg, diag=diag)
    if kind == "static":
        return static_cacher(env_cfg)
    if kind == "random":
        return random_cacher(env_cfg)
    if kind in CACHE_POLICIES:
        return classical_cacher(kind, env_cfg)
    raise ValueError(f"unknown cacher {kind!r}; expected one of {CACHERS}")
