"""T2DRL — the paper's Algorithm 1 on one edge cell, port of
``repro.core.t2drl``: per frame the cacher picks rho (long timescale), per
slot the allocator picks (b, xi) (short timescale), the environment scores
the result, and in training both learn from replay.

The loop is written against the agent protocol (``repro_torch.agents``,
DESIGN.md §12); ``_agents`` is the one place method names are dispatched:

  T2DRL             allocator="d3pg",  cacher="ddqn"
  DDPG-based T2DRL  allocator="ddpg",  cacher="ddqn"
  RCARS             allocator="rcars", cacher="random"

plus cacher="static" (SCHRS' cache).  SCHRS' genetic allocator (ROADMAP
A.5) and the classical cachers (A.7) raise ``NotImplementedError``.

Training (``train_t2drl``) runs one cell: ``num_envs=1``,
``policy="independent"``.  The vector-env modes, per-cell user masks,
scenario schedules and telemetry raise, naming their ROADMAP items (A.6,
A.8).  An episode keeps the reference's semantics (``_episode_core``):

- replay writes are batched once per frame, so a slot's minibatch samples
  the buffer as of the frame start, and a slot updates when
  ``min(size0 + k + 1, cap) > warmup and size0 > 0``;
- the allocator acts, the env steps, and only then does the slot's update
  run, with the state it acted with;
- the DDQN's frame transitions ``(gamma_t, a_t, r_t, gamma_{t+1})`` for
  t < T-1 are added after the frame loop, one at a time, each followed by
  an update once the buffer holds more than a batch;
- the frame reward subtracts the storage penalty Xi (the erratum-corrected
  sign, DESIGN.md §8 item 2).

Random draws come from one ``torch.Generator`` on the device, in a fixed
order; they differ from JAX's threefry streams by design, so whole
episodes are held against the reference in distribution and single
updates by injected draws.

Every D3PG action runs its L-step reverse chain in one ``ddpm_chain``
launch (a greedy d3pg episode launches it exactly T*K times); a D3PG
update adds two ``ddpm_chain`` launches (the target chain over the
minibatch, then the policy chain with its record) and one
``ddpm_chain_bwd`` launch (the actor's policy gradient), and no
``ddpm_step`` or ``ddpm_step_bwd``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional

import torch

from repro_torch.agents.base import FrameObs, SlotObs
from repro_torch.device import make_generator
from .baselines import GACfg
from .buffers import (buffer_add, buffer_add_many, buffer_init,
                      buffer_sample)
from .d3pg import D3PGCfg, d3pg_init
from .ddqn import DDQNCfg, ddqn_init
from .env import (EnvCfg, EnvState, ModelParams, env_advance_frame,
                  env_reset, env_set_cache, env_step_slot, make_models,
                  masked_mean, observe)

STAT_KEYS = ("episode_reward", "mean_reward", "hit_ratio", "utility",
             "delay", "quality", "deadline_viol", "storage_viol")


@dataclasses.dataclass(frozen=True)
class ObsCfg:
    """Telemetry switches of the JAX ``T2DRLCfg.obs``.  The port's
    telemetry waits for ROADMAP A.8: ``enabled=True`` raises in
    ``train_t2drl``."""
    enabled: bool = False
    learner: bool = True
    replay: bool = True


@dataclasses.dataclass(frozen=True)
class T2DRLCfg:
    """Static configuration of the two-timescale loop; the fields of the
    JAX ``T2DRLCfg``.  ``policy`` and ``independent_impl`` select
    vector-env modes, which wait for ROADMAP A.6 (one cell trains as
    ``"independent"``); ``ga`` configures SCHRS (A.5)."""
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


@functools.lru_cache(maxsize=32)
def _agents(cfg: T2DRLCfg):
    """The (allocator, cacher) Agent pair for ``cfg`` — the single place
    method names are dispatched (DESIGN.md §12); built once per config."""
    from repro_torch.agents.allocators import make_allocator
    from repro_torch.agents.cachers import make_cacher
    if cfg.updates_per_slot < 1:
        raise ValueError("updates_per_slot must be >= 1")
    return (make_allocator(cfg.allocator, cfg.env, cfg.d3pg_cfg(), cfg.ga),
            make_cacher(cfg.cacher, cfg.ddqn_cfg(), cfg.env))


def t2drl_init(generator: torch.Generator, cfg: T2DRLCfg) -> dict:
    """Fresh train state on the generator's device, in the JAX layout:
    ``{"models", "d3pg", "ddqn", "ebuf", "fbuf", "cache"}`` whatever the
    method (non-learned methods never read their learner slots).
    ``"cache"`` is the classical cachers' state machine, an empty
    placeholder until they are ported (ROADMAP A.7).  Draws: the model
    zoo, then the DDQN, then the D3PG networks."""
    env = cfg.env
    d3, dq = cfg.d3pg_cfg(), cfg.ddqn_cfg()
    dev = generator.device
    models = make_models(generator, env)
    ddqn = ddqn_init(dq, generator)
    d3pg = d3pg_init(d3, generator)
    f32 = functools.partial(torch.zeros, device=dev)
    i64 = functools.partial(torch.zeros, dtype=torch.int64, device=dev)
    S, A, U, M = env.state_dim, env.action_dim, env.U, env.M
    slot_item = {"s": f32(S), "a": f32(A), "r": f32(()), "s1": f32(S),
                 "req": i64(U), "rho": f32(M), "req1": i64(U),
                 "rho1": f32(M)}
    frame_item = {"s": i64(()), "a": i64(()), "r": f32(()), "s1": i64(())}
    return {"models": models, "d3pg": d3pg, "ddqn": ddqn,
            "ebuf": buffer_init(d3.buffer, slot_item),
            "fbuf": buffer_init(dq.buffer, frame_item), "cache": {}}


# -- exploration / learning-rate schedules --------------------------------------

def _eps_frac(cfg: T2DRLCfg, episode):
    """Annealing fraction in [0, 1] under ``cfg.eps_schedule`` (an unknown
    name raises)."""
    episode = torch.as_tensor(episode, dtype=torch.float32)
    frac = torch.clamp(episode / max(cfg.eps_decay_episodes, 1), 0.0, 1.0)
    if cfg.eps_schedule == "cosine":
        return 0.5 * (1.0 - torch.cos(math.pi * frac))
    if cfg.eps_schedule != "linear":
        raise ValueError(f"unknown eps_schedule {cfg.eps_schedule!r}; "
                         "expected 'linear' or 'cosine'")
    return frac


def episode_epsilon(cfg: T2DRLCfg, episode):
    """DDQN epsilon at ``episode`` (number or tensor of episode indices),
    f32."""
    frac = _eps_frac(cfg, episode)
    return cfg.eps_start + (cfg.eps_end - cfg.eps_start) * frac


def episode_sigma(cfg: T2DRLCfg, episode):
    """Exploration-noise schedule: from explore_sigma down to 0.02 on the
    epsilon schedule; zero for the non-learned allocators."""
    episode = torch.as_tensor(episode, dtype=torch.float32)
    if cfg.allocator not in ("d3pg", "ddpg"):
        return torch.zeros_like(episode)
    frac = _eps_frac(cfg, episode)
    d3 = cfg.d3pg_cfg()
    return d3.explore_sigma * (1.0 - frac) + 0.02 * frac


def episode_lr_scale(cfg: T2DRLCfg, episode):
    """Actor/critic LR warmdown factor at ``episode``: 1 -> lr_end_scale
    over ``lr_warmdown_episodes`` (identically 1 for "const")."""
    episode = torch.as_tensor(episode, dtype=torch.float32)
    if cfg.lr_schedule == "const":
        return torch.ones_like(episode)
    if cfg.lr_schedule not in ("linear", "cosine"):
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}; "
                         "expected 'const', 'linear' or 'cosine'")
    if cfg.lr_warmdown_episodes < 1:
        raise ValueError(f"lr_schedule={cfg.lr_schedule!r} requires "
                         "lr_warmdown_episodes >= 1")
    frac = torch.clamp(episode / cfg.lr_warmdown_episodes, 0.0, 1.0)
    if cfg.lr_schedule == "cosine":
        frac = 0.5 * (1.0 - torch.cos(math.pi * frac))
    return 1.0 + (cfg.lr_end_scale - 1.0) * frac


def _training_steps(cfg: T2DRLCfg, episodes: int) -> List[dict]:
    """Each episode's schedule values as host floats (of the f32 values):
    ``eps``, ``sigma`` and, under an LR warmdown, ``lr_actor`` and
    ``lr_critic``."""
    alloc, _ = _agents(cfg)
    e = torch.arange(episodes, dtype=torch.float32)
    cols = {"eps": episode_epsilon(cfg, e), "sigma": episode_sigma(cfg, e)}
    if alloc.learns and cfg.lr_schedule != "const":
        scale = episode_lr_scale(cfg, e)
        cols["lr_actor"] = cfg.lr_actor * scale
        cols["lr_critic"] = cfg.lr_critic * scale
    vals = {k: v.tolist() for k, v in cols.items()}
    return [{k: v[i] for k, v in vals.items()} for i in range(episodes)]


def _update_aux(step: dict) -> dict:
    """Reserved minibatch auxiliaries for Agent.update (DESIGN.md §12):
    the schedule-driven learning rates.  The active-user mask joins them
    with per-cell user masks (ROADMAP A.6)."""
    if "lr_actor" not in step:
        return {}
    return {"lr_actor": step["lr_actor"], "lr_critic": step["lr_critic"]}


def _slot_updates(alloc, cfg: T2DRLCfg, state, generator, step: dict,
                  sample):
    """``updates_per_slot`` sample-and-update steps of the allocator, each
    on its own minibatch ``sample(generator)``."""
    for _ in range(cfg.updates_per_slot):
        batch = sample(generator)
        state, _ = alloc.update(state, {**batch, **_update_aux(step)},
                                generator)
    return state


# -- the episode ------------------------------------------------------------------

_SLOT_COLS = ("r", "hit", "G", "delay", "quality", "viol")


def _record_slot(cols: dict, ec: EnvCfg, r, m) -> None:
    """Append one slot's reward and metrics to the episode's columns."""
    cols["r"].append(r)
    cols["hit"].append(masked_mean(m["cached"]))
    cols["G"].append(masked_mean(m["G"]))
    cols["delay"].append(masked_mean(m["d_tl"]))
    cols["quality"].append(masked_mean(m["quality"]))
    cols["viol"].append(masked_mean((m["d_tl"] > ec.tau).to(torch.float32)))


def _episode_stats(cols: dict, storage_viols: list) -> dict:
    """The eight episode stats (``STAT_KEYS``) from the slot columns and
    the frames' storage violations, as 0-dim device tensors."""
    col = {k: torch.stack(v) for k, v in cols.items()}
    return {"episode_reward": torch.sum(col["r"]),
            "mean_reward": torch.mean(col["r"]),
            "hit_ratio": torch.mean(col["hit"]),
            "utility": torch.mean(col["G"]),
            "delay": torch.mean(col["delay"]),
            "quality": torch.mean(col["quality"]),
            "deadline_viol": torch.mean(col["viol"]),
            "storage_viol": torch.mean(torch.stack(storage_viols))}


def _storage_viol(rho, models: ModelParams, ec: EnvCfg):
    return (torch.sum(rho * models.c) > ec.C).to(torch.float32)


def _episode_core(ts: dict, cfg: T2DRLCfg, generator: torch.Generator,
                  step: dict):
    """One training episode of Algorithm 1 for a single cell, with the
    reference's semantics (module docstring).  ``step`` holds the
    episode's schedule values (``eps``, ``sigma``, optional ``lr_*``) as
    host floats.  Learned state, buffers included, is updated in place.
    Returns ``(ts, stats)``, the eight stats as 0-dim device tensors (no
    host read inside the episode; the update gates read host counters
    only)."""
    ec = cfg.env
    d3, dq = cfg.d3pg_cfg(), cfg.ddqn_cfg()
    alloc, cacher = _agents(cfg)
    models: ModelParams = ts["models"]
    alloc_state, cacher_state = ts["d3pg"], ts["ddqn"]
    ebuf, fbuf = ts["ebuf"], ts["fbuf"]
    cap_e = d3.buffer
    env = env_reset(generator, ec)
    cols = {k: [] for k in _SLOT_COLS}
    gammas, a_ints, r_frames, storage_viols = [], [], [], []

    def sample(g):
        return buffer_sample(ebuf, g, d3.batch)

    for _ in range(ec.T):
        env = env_advance_frame(env, ec)
        gamma_t = env.gamma_idx
        a_int, rho = cacher.act(cacher_state, FrameObs(gamma_t, models),
                                generator, step)
        env = env_set_cache(env, rho)
        size0 = ebuf["size"]
        items, frame_r = [], []
        s = observe(env, ec, models) if alloc.learns else None
        for k in range(ec.K):
            b, xi = alloc.act(alloc_state, SlotObs(s, env, models),
                              generator, step)
            env1, r, m = env_step_slot(env, ec, models, b, xi)
            frame_r.append(r)
            _record_slot(cols, ec, r, m)
            if alloc.learns:
                s1 = observe(env1, ec, models)
                items.append({"s": s, "a": torch.cat([b, xi]), "r": r,
                              "s1": s1, "req": env.req, "rho": env.rho,
                              "req1": env1.req, "rho1": env1.rho})
                # transitions stored so far = frame-start size + slot
                # count (the write itself is batched at frame end)
                if min(size0 + k + 1, cap_e) > cfg.warmup and size0 > 0:
                    alloc_state = _slot_updates(alloc, cfg, alloc_state,
                                                generator, step, sample)
                s = s1
            env = env1
        if alloc.learns:
            ebuf = buffer_add_many(
                ebuf, {k: torch.stack([it[k] for it in items])
                       for k in items[0]})
        # frame reward (32): mean slot reward minus the storage penalty
        # (erratum-corrected sign, DESIGN.md §8)
        storage_viol = _storage_viol(rho, models, ec)
        r_frames.append(torch.mean(torch.stack(frame_r))
                        - storage_viol * ec.Xi)
        gammas.append(gamma_t)
        a_ints.append(a_int)
        storage_viols.append(storage_viol)

    # DDQN frame transitions (gamma_t, a_t, r_t, gamma_{t+1}) for t < T-1
    if cacher.learns:
        for t in range(ec.T - 1):
            fbuf = buffer_add(fbuf, {"s": gammas[t], "a": a_ints[t],
                                     "r": r_frames[t], "s1": gammas[t + 1]})
            if fbuf["size"] > dq.batch:
                batch = buffer_sample(fbuf, generator, dq.batch)
                cacher_state, _ = cacher.update(cacher_state, batch,
                                                generator)

    ts = {"models": models, "d3pg": alloc_state, "ddqn": cacher_state,
          "ebuf": ebuf, "fbuf": fbuf, "cache": ts["cache"]}
    return ts, _episode_stats(cols, storage_viols)


def _stats_to_host(stats: dict) -> Dict[str, float]:
    """One host read for the eight stats."""
    return dict(zip(STAT_KEYS,
                    torch.stack([stats[k] for k in STAT_KEYS]).tolist()))


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue "
                               f"A, item {item})")


def train_t2drl(cfg: T2DRLCfg, *, episodes: Optional[int] = None,
                num_envs: int = 1, user_counts=None,
                share_models: bool = False, log_every: int = 0,
                callback=None, mods=None, writer=None, device=None):
    """Train one edge cell for ``episodes`` episodes (default
    ``cfg.episodes``) on ``resolve_device(device)``: the card unless
    ``device="cpu"`` is passed.

    Everything is drawn from one generator seeded with ``cfg.seed``: the
    initial state (``t2drl_init``), then each episode's env, actions,
    minibatches and chains in order.  ``log_every`` prints a progress
    line every N episodes; ``callback(episode, stats)`` runs after each
    episode with its stats as host floats.  ``num_envs > 1``,
    ``cfg.policy="shared"`` and ``user_counts`` (ROADMAP A.6), and
    ``mods``, ``writer`` and ``cfg.obs.enabled`` (A.8) raise
    ``NotImplementedError``.

    Returns ``(ts, history)``: the final train state and the per-episode
    stats as lists of host floats (one host read per episode)."""
    if num_envs != 1:
        raise _not_ported(f"num_envs={num_envs} (vector-env training)", 6)
    if cfg.policy != "independent":
        raise _not_ported(f"policy={cfg.policy!r} (the shared learner)", 6)
    if user_counts is not None:
        raise _not_ported("user_counts (per-cell user masks)", 6)
    if mods is not None:
        raise _not_ported("mods (scenario schedules)", 8)
    if writer is not None or cfg.obs.enabled:
        raise _not_ported("telemetry (writer, obs.enabled)", 8)
    episodes = episodes or cfg.episodes
    generator = make_generator(cfg.seed, device)
    ts = t2drl_init(generator, cfg)
    history = {k: [] for k in STAT_KEYS}
    for ep, step in enumerate(_training_steps(cfg, episodes)):
        ts, stats = _episode_core(ts, cfg, generator, step)
        host = _stats_to_host(stats)
        for k, v in host.items():
            history[k].append(v)
        if log_every and (ep + 1) % log_every == 0:
            print(f"episode {ep + 1}/{episodes} " + " ".join(
                f"{k}={v:.4g}" for k, v in host.items()), flush=True)
        if callback is not None:
            callback(ep, host)
    return ts, history


# -- policy deployment (inference only, DESIGN.md §11/§12) ------------------------

def export_policy(ts: dict, cfg: T2DRLCfg, cell: int = 0) -> dict:
    """The inference-only policy of a single-cell train state, as each
    agent exports it: ``{"actor": Denoiser|MLP}`` and ``{"ddqn": {"q":
    MLP}}``, keys only for learned components (empty for RCARS).  The
    modules are the train state's own, not copies.  ``cell`` other than 0
    (batched states) waits for ROADMAP A.6."""
    if cell != 0:
        raise _not_ported("export_policy(cell>0) (batched train states)", 6)
    alloc, cacher = _agents(cfg)
    pol = {}
    if alloc.learns:
        pol.update(alloc.export(ts["d3pg"]))
    if cacher.learns:
        pol.update(cacher.export(ts["ddqn"]))
    return pol


def policy_init(cfg: T2DRLCfg, seed: int, device=None) -> dict:
    """A fresh inference policy on ``resolve_device(device)``: the
    ``export_policy`` of the agents' fresh states."""
    alloc, cacher = _agents(cfg)
    g = make_generator(seed, device)
    pol = {}
    for agent in (alloc, cacher):
        if agent.learns:
            pol.update(agent.export(agent.init(g)))
    return pol


def greedy_slot_action(policy, cfg: T2DRLCfg, env: EnvState,
                       models: ModelParams, generator=None, mask=None, *,
                       x_L=None, noises=None, impl: str = "chain"):
    """Greedy (no exploration noise) per-slot allocation: the amended
    ``(b, xi)`` of the allocator's ``greedy``.  ``generator`` drives the
    diffusion actor's reverse chain; ``x_L``/``noises`` inject its draws
    instead; ``impl`` picks its kernels (``reverse_sample``)."""
    alloc, _ = _agents(cfg)
    s = observe(env, cfg.env, models, mask) if alloc.learns else None
    return alloc.greedy(policy, SlotObs(s, env, models, mask), generator,
                        x_L=x_L, noises=noises, impl=impl)


def greedy_frame_cache(policy, cfg: T2DRLCfg, models: ModelParams,
                       gamma_idx, generator=None):
    """Greedy (eps = 0) per-frame caching vector rho, from the cacher's
    ``greedy``."""
    _, cacher = _agents(cfg)
    return cacher.greedy(policy, FrameObs(gamma_idx, models), generator)


def greedy_episode(policy, cfg: T2DRLCfg, models: ModelParams,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One greedy episode of Algorithm 1 from an exported policy: T frames
    of K slots, each agent acting through its ``greedy`` (no exploration,
    no replay, no updates).  Returns the eight episode stats of
    ``_episode_core`` as 0-dim device tensors (no host read inside the
    episode)."""
    ec = cfg.env
    env = env_reset(generator, ec)
    cols = {k: [] for k in _SLOT_COLS}
    storage_viols = []
    for _ in range(ec.T):
        env = env_advance_frame(env, ec)
        rho = greedy_frame_cache(policy, cfg, models, env.gamma_idx,
                                 generator)
        env = env_set_cache(env, rho)
        for _ in range(ec.K):
            b, xi = greedy_slot_action(policy, cfg, env, models, generator)
            env, r, m = env_step_slot(env, ec, models, b, xi)
            _record_slot(cols, ec, r, m)
        storage_viols.append(_storage_viol(rho, models, ec))
    return _episode_stats(cols, storage_viols)


def run_eval(policy, models: ModelParams, cfg: T2DRLCfg, *,
             episodes: int = 10, seed: int = 10_000,
             device=None) -> Dict[str, List[float]]:
    """Greedy evaluation: per-episode stats as lists of host floats (one
    host read per episode).  ``policy`` and ``models`` must lie on
    ``resolve_device(device)``."""
    g = make_generator(seed, device)
    hist = {k: [] for k in STAT_KEYS}
    for _ in range(episodes):
        for k, v in _stats_to_host(greedy_episode(policy, cfg, models,
                                                  g)).items():
            hist[k].append(v)
    return hist


def eval_t2drl(policy, models: ModelParams, cfg: T2DRLCfg, *,
               episodes: int = 10, seed: int = 10_000,
               device=None) -> Dict[str, float]:
    """Greedy evaluation (no exploration, no updates) of one cell from an
    exported policy (``export_policy``) and its model zoo: the eight stats
    of the JAX ``eval_t2drl``, as means over episodes."""
    hist = run_eval(policy, models, cfg, episodes=episodes, seed=seed,
                    device=device)
    return {k: sum(v) / len(v) for k, v in hist.items()}
