"""T2DRL greedy serving — the paper's Algorithm 1 without learning: per
frame the cacher picks rho, per slot the allocator picks (b, xi), and the
environment scores the result.  Port of the serving half of
``repro.core.t2drl`` (``greedy_frame_cache``, ``greedy_slot_action``,
``eval_t2drl`` / ``run_eval``).

Methods, as in ``repro.core.t2drl``:

  T2DRL             allocator="d3pg",  cacher="ddqn"
  DDPG-based T2DRL  allocator="ddpg",  cacher="ddqn"
  RCARS             allocator="rcars", cacher="random"

plus cacher="static" (SCHRS' cache).  The SCHRS genetic allocator and the
classical cachers (lru/lfu/lru-ghost/arc) raise ``NotImplementedError``
until their ROADMAP items are ported; the agent protocol (``agents/``)
arrives with the training slice, so a small dispatch here stands in for it.

Every D3PG action runs its L-step reverse chain in one ``ddpm_chain``
launch, so a greedy d3pg episode launches it exactly T*K times
(``impl="step"`` in ``greedy_slot_action``: L*T*K ``ddpm_step`` launches).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import torch

from repro_torch.device import make_generator
from .baselines import GACfg, random_cache, rcars_allocate, \
    static_popular_cache
from .d3pg import (D3PGCfg, actor_act, actor_init, amend_actions,
                   make_actor_schedule)
from .ddqn import DDQNCfg, amend_caching, ddqn_act, qnet_init
from .env import (EnvCfg, EnvState, ModelParams, env_advance_frame,
                  env_reset, env_set_cache, env_step_slot, masked_mean,
                  observe)

ALLOCATORS = ("d3pg", "ddpg", "rcars")
CACHERS = ("ddqn", "static", "random")
_LATER = {
    "schrs": "the SCHRS genetic allocator (ROADMAP queue A, item 2)",
    **dict.fromkeys(("lru", "lfu", "lru-ghost", "arc"),
                    "the classical cachers (ROADMAP queue A, item 4)"),
}

STAT_KEYS = ("episode_reward", "mean_reward", "hit_ratio", "utility",
             "delay", "quality", "deadline_viol", "storage_viol")


@dataclasses.dataclass(frozen=True)
class ObsCfg:
    """Telemetry switches of the JAX ``T2DRLCfg.obs``; the port's telemetry
    arrives with the training slice, so nothing reads them yet."""
    enabled: bool = False
    learner: bool = True
    replay: bool = True


@dataclasses.dataclass(frozen=True)
class T2DRLCfg:
    """Static configuration of the two-timescale loop; the fields of the
    JAX ``T2DRLCfg``.  Greedy serving reads ``env``, ``allocator``,
    ``cacher`` and ``L``; the training fields wait for the training
    slice."""
    env: EnvCfg = EnvCfg()
    allocator: str = "d3pg"     # d3pg | ddpg | schrs | rcars
    cacher: str = "ddqn"        # ddqn | static | random
    policy: str = "independent"  # vector-env mode: independent | shared
    independent_impl: str = "fused"  # B>1 independent learners: fused | vmap
    episodes: int = 500
    warmup: int = 200           # slot transitions before D3PG updates
    eps_start: float = 1.0      # DDQN epsilon-greedy schedule (per episode)
    eps_end: float = 0.05
    eps_decay_episodes: int = 300
    eps_schedule: str = "linear"    # linear | cosine
    lr_actor: float = 1e-6
    lr_critic: float = 1e-6
    lr_ddqn: float = 1e-6
    lr_schedule: str = "const"      # const | linear | cosine
    lr_warmdown_episodes: int = 0
    lr_end_scale: float = 0.1
    updates_per_slot: int = 1
    L: int = 5                  # D3PG denoising steps
    seed: int = 0
    ga: GACfg = GACfg()
    obs: ObsCfg = ObsCfg()

    def d3pg_cfg(self) -> D3PGCfg:
        return D3PGCfg(state_dim=self.env.state_dim,
                       action_dim=self.env.action_dim, L=self.L,
                       actor_kind="mlp" if self.allocator == "ddpg"
                       else "diffusion",
                       lr_actor=self.lr_actor, lr_critic=self.lr_critic)

    def ddqn_cfg(self) -> DDQNCfg:
        return DDQNCfg(M=self.env.M, J=len(self.env.gammas),
                       lr=self.lr_ddqn)


def _check_methods(cfg: T2DRLCfg) -> None:
    for kind, known in ((cfg.allocator, ALLOCATORS), (cfg.cacher, CACHERS)):
        if kind in _LATER:
            raise NotImplementedError(f"{kind!r} is not ported yet: "
                                      f"{_LATER[kind]}")
        if kind not in known:
            raise ValueError(f"unknown method {kind!r}; the port serves "
                             f"{ALLOCATORS} x {CACHERS}")


_actor_schedule = functools.lru_cache(maxsize=16)(make_actor_schedule)


def policy_init(cfg: T2DRLCfg, seed: int, device=None) -> dict:
    """A fresh inference policy on ``resolve_device(device)``: the
    ``export_policy`` tree of the JAX package, as modules — ``{"actor":
    Denoiser|MLP}`` for d3pg/ddpg and ``{"ddqn": {"q": MLP}}`` for the
    DDQN cacher (keys only for learned components)."""
    _check_methods(cfg)
    g = make_generator(seed, device)
    pol = {}
    if cfg.allocator in ("d3pg", "ddpg"):
        pol["actor"] = actor_init(cfg.d3pg_cfg(), g)
    if cfg.cacher == "ddqn":
        pol["ddqn"] = qnet_init(cfg.ddqn_cfg(), g)
    return pol


def greedy_slot_action(policy, cfg: T2DRLCfg, env: EnvState,
                       models: ModelParams, generator=None, mask=None, *,
                       x_L=None, noises=None, impl: str = "chain"):
    """Greedy (no exploration noise) per-slot allocation: the amended
    ``(b, xi)``.  ``generator`` drives the diffusion actor's reverse chain;
    ``x_L``/``noises`` inject its draws instead; ``impl`` picks its kernels
    (``reverse_sample``)."""
    _check_methods(cfg)
    if cfg.allocator == "rcars":
        return rcars_allocate(env, cfg.env)
    d3 = cfg.d3pg_cfg()
    s = observe(env, cfg.env, models, mask)
    raw = actor_act(policy["actor"], d3, _actor_schedule(d3), s, generator,
                    x_L=x_L, noises=noises, impl=impl)
    return amend_actions(raw, env.req, env.rho, cfg.env.U, mask=mask)


def greedy_frame_cache(policy, cfg: T2DRLCfg, models: ModelParams,
                       gamma_idx, generator=None):
    """Greedy (eps = 0) per-frame caching vector rho."""
    _check_methods(cfg)
    if cfg.cacher == "ddqn":
        dq = cfg.ddqn_cfg()
        a_int = ddqn_act(policy["ddqn"], dq, gamma_idx)
        return amend_caching(a_int, dq, models.c, cfg.env.C)
    if cfg.cacher == "static":
        return static_popular_cache(models, cfg.env)
    return random_cache(generator, models, cfg.env)


def greedy_episode(policy, cfg: T2DRLCfg, models: ModelParams,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One greedy episode of Algorithm 1 (``_episode_core(train=False)``):
    T frames of K slots.  Returns the eight episode stats as 0-dim device
    tensors (no host read inside the episode)."""
    _check_methods(cfg)
    ec = cfg.env
    env = env_reset(generator, ec)
    slot_r, slot_hit, slot_G, slot_delay, slot_q, slot_viol = \
        [], [], [], [], [], []
    storage_viol = []
    for _ in range(ec.T):
        env = env_advance_frame(env, ec)
        rho = greedy_frame_cache(policy, cfg, models, env.gamma_idx,
                                 generator)
        env = env_set_cache(env, rho)
        for _ in range(ec.K):
            b, xi = greedy_slot_action(policy, cfg, env, models, generator)
            env, r, m = env_step_slot(env, ec, models, b, xi)
            slot_r.append(r)
            slot_hit.append(masked_mean(m["cached"]))
            slot_G.append(masked_mean(m["G"]))
            slot_delay.append(masked_mean(m["d_tl"]))
            slot_q.append(masked_mean(m["quality"]))
            slot_viol.append(masked_mean(
                (m["d_tl"] > ec.tau).to(torch.float32)))
        storage_viol.append(
            (torch.sum(rho * models.c) > ec.C).to(torch.float32))
    r = torch.stack(slot_r)
    return {"episode_reward": torch.sum(r), "mean_reward": torch.mean(r),
            "hit_ratio": torch.mean(torch.stack(slot_hit)),
            "utility": torch.mean(torch.stack(slot_G)),
            "delay": torch.mean(torch.stack(slot_delay)),
            "quality": torch.mean(torch.stack(slot_q)),
            "deadline_viol": torch.mean(torch.stack(slot_viol)),
            "storage_viol": torch.mean(torch.stack(storage_viol))}


def run_eval(policy, models: ModelParams, cfg: T2DRLCfg, *,
             episodes: int = 10, seed: int = 10_000,
             device=None) -> Dict[str, List[float]]:
    """Greedy evaluation: per-episode stats as lists of host floats (one
    host read per episode).  ``policy`` and ``models`` must lie on
    ``resolve_device(device)``."""
    g = make_generator(seed, device)
    hist = {k: [] for k in STAT_KEYS}
    for _ in range(episodes):
        stats = greedy_episode(policy, cfg, models, g)
        vals = torch.stack([stats[k] for k in STAT_KEYS]).tolist()
        for k, v in zip(STAT_KEYS, vals):
            hist[k].append(v)
    return hist


def eval_t2drl(policy, models: ModelParams, cfg: T2DRLCfg, *,
               episodes: int = 10, seed: int = 10_000,
               device=None) -> Dict[str, float]:
    """Greedy evaluation (no exploration, no updates) of one cell: the
    eight stats of the JAX ``eval_t2drl``, as means over episodes."""
    hist = run_eval(policy, models, cfg, episodes=episodes, seed=seed,
                    device=device)
    return {k: sum(v) / len(v) for k, v in hist.items()}
