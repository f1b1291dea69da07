"""The legacy ``*_batch`` helpers as thin shims over :func:`vmap_agent`,
port of ``repro.agents.compat``: B independent learners' init and one
minibatch step each, with generators in place of the reference's keys.
"""
from __future__ import annotations

from repro_torch.core.d3pg import D3PGCfg
from repro_torch.core.ddqn import DDQNCfg
from repro_torch.core.env import EnvCfg

from .allocators import d3pg_allocator
from .base import vmap_agent
from .cachers import ddqn_cacher


def _aux(**kw) -> dict:
    return {k: v for k, v in kw.items() if v is not None}


def d3pg_init_batch(generators, cfg: D3PGCfg) -> dict:
    """B independent actor/critic/optimizer stacks, learner b from
    ``generators[b]``."""
    return vmap_agent(d3pg_allocator(cfg)).init(generators)


def d3pg_update_batch(params, cfg: D3PGCfg, sched, batch, generators, *,
                      lr_a=None, lr_c=None, mask=None):
    """One minibatch step per learner in one fused pass: ``params`` and
    ``batch`` carry a leading (B,) axis, ``mask`` is (B, U).  ``sched`` is
    the actor's schedule, honoured as given.  Returns ``(params,
    losses)``, the losses (B,) each."""
    return vmap_agent(d3pg_allocator(cfg, sched)).update(
        params, {**batch, **_aux(lr_actor=lr_a, lr_critic=lr_c, mask=mask)},
        generators)


def ddqn_init_batch(generators, cfg: DDQNCfg) -> dict:
    """B independent Q/target/optimizer stacks."""
    return vmap_agent(ddqn_cacher(cfg, EnvCfg(M=cfg.M))).init(generators)


def ddqn_update_batch(params, cfg: DDQNCfg, batch, *, lr=None):
    """One minibatch step per learner; returns ``(params, losses (B,))``."""
    B = batch["s"].shape[0]
    new, metrics = vmap_agent(ddqn_cacher(cfg, EnvCfg(M=cfg.M))).update(
        params, {**batch, **_aux(lr=lr)}, [None] * B)   # keyless update
    return new, metrics["loss"]
