"""T2DRL — the paper's Algorithm 1, port of ``repro.core.t2drl``: per frame
the cacher picks rho (long timescale), per slot the allocator picks (b, xi)
(short timescale), the environment scores the result, and in training both
learn from replay.

The loop is written against the agent protocol (``repro_torch.agents``,
DESIGN.md §12); ``_agents`` is the one place method names are dispatched:

  T2DRL             allocator="d3pg",  cacher="ddqn"
  DDPG-based T2DRL  allocator="ddpg",  cacher="ddqn"
  SCHRS             allocator="schrs", cacher="static"
  RCARS             allocator="rcars", cacher="random"

plus the classical cache-hierarchy baselines (DESIGN.md §14): cacher in
{"lru", "lfu", "lru-ghost", "arc"}, stateful non-learned cachers whose
state machine lives in the train state's ``"cache"`` slot and replays
each frame's requests after the frame (``Agent.step_frame``; one batched
replay serves all B cells of the vector-env cores), with any allocator.

Scenario schedules (DESIGN.md §9, ``repro_torch.scenarios``) reach the
env through ``mods=``: each draw takes its slot's ``SlotMod`` and each
frame its ``P_gamma``.  Telemetry (DESIGN.md §15): ``cfg.obs`` adds the
updates' diagnostics (``diag/...``) and the replay occupancy to the
history, and a ``writer`` (``repro_torch.obs.MetricWriter``) receives the
run's manifest, ``train_chunk`` and ``eval`` records.

Vector-env training (DESIGN.md §6, §13) runs B cells, each with its own
model zoo, replay buffers and Markov chains, and optional per-cell user
masks (``user_counts``): ``policy="independent"`` trains B learners, as
one fused stacked program (``independent_impl="fused"``,
``_episode_core_fused``) or as a loop of the single-cell episode over the
cells (``"vmap"``, the fused path's reference); ``policy="shared"`` trains
one learner on a minibatch pooled over the cells
(``_episode_core_shared``).  Cell b draws from its own generator
(``cell_generators``; cell 0's is seeded as the single-cell run's, so cell
0 of an independent run replays ``num_envs=1``), and at each draw site it
draws what a single cell draws there.  Population schedules (per-learner
step values, ``core/population.py``) reach the fused core.

An episode keeps the reference's semantics (``_episode_core``):

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
``ddpm_step`` or ``ddpm_step_bwd``.  The fused learners launch the same
counts whatever B: one stacked chain a slot for all B actors, and 2 + 1
stacked launches a stacked update.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.agents.base import FrameObs, SlotObs, cell_of, vmap_agent
from repro_torch.device import make_generator, resolve_device
from repro_torch.obs import profiling
from repro_torch.obs.taps import (ObsCfg, broadcast_diag, combine_updates,
                                  reduce_update_diag)
from repro_torch.obs.writer import progress_line
from .baselines import GACfg
from .buffers import (buffer_add, buffer_add_batch, buffer_add_many,
                      buffer_add_many_batch, buffer_add_many_stacked,
                      buffer_cell, buffer_init, buffer_occupancy,
                      buffer_sample,
                      buffer_sample_batch, buffer_sample_stacked,
                      set_buffer_cell, stack_buffers)
from .cache_policies import cache_state_init
from .d3pg import D3PGCfg, d3pg_init, d3pg_learner, stack_d3pg
from .ddqn import DDQNCfg, ddqn_init, ddqn_learner, stack_ddqn
from .env import (EnvCfg, EnvState, ModelParams, ScenarioSchedule,
                  env_advance_frame, env_reset, env_reset_batch,
                  env_set_cache, env_step_slot, make_models, make_user_masks,
                  masked_mean, observe, schedule_frame_P, schedule_slot_mod,
                  stack_models)

STAT_KEYS = ("episode_reward", "mean_reward", "hit_ratio", "utility",
             "delay", "quality", "deadline_viol", "storage_viol")


@dataclasses.dataclass(frozen=True)
class T2DRLCfg:
    """Static configuration of the two-timescale loop; the fields of the
    JAX ``T2DRLCfg``.  ``policy`` ("independent" | "shared") and
    ``independent_impl`` ("fused" | "vmap") select the vector-env mode;
    ``ga`` configures SCHRS; ``obs`` the telemetry (``ObsCfg``)."""
    env: EnvCfg = EnvCfg()
    allocator: str = "d3pg"     # d3pg | ddpg | schrs | rcars
    cacher: str = "ddqn"        # ddqn | static | random | a classical one
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
    diag = cfg.obs.learner_on
    return (make_allocator(cfg.allocator, cfg.env, cfg.d3pg_cfg(), cfg.ga,
                           diag=diag),
            make_cacher(cfg.cacher, cfg.ddqn_cfg(), cfg.env, diag=diag))


def t2drl_init(generator: torch.Generator, cfg: T2DRLCfg) -> dict:
    """Fresh train state on the generator's device, in the JAX layout:
    ``{"models", "d3pg", "ddqn", "ebuf", "fbuf", "cache"}`` whatever the
    method (non-learned methods never read their learner slots).
    ``"cache"`` is the classical cachers' state machine
    (``cache_state_init``), which draws nothing.  Draws: the model zoo,
    then the DDQN, then the D3PG networks."""
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
            "fbuf": buffer_init(dq.buffer, frame_item),
            "cache": cache_state_init(M, dev)}


def cell_generators(seed: int, num_envs: int, device=None) -> list:
    """One generator per cell on ``resolve_device(device)``.  Cell 0's is
    seeded with ``seed`` itself, as ``train_t2drl(num_envs=1)`` seeds its
    one cell, so cell 0 of any batch replays the single-cell run; cell
    b >= 1's with the 64-bit integer that
    ``numpy.random.SeedSequence([seed, b]).generate_state(2, uint32)``
    gives (low word first)."""
    gens = [make_generator(seed, device)]
    for b in range(1, num_envs):
        lo, hi = np.random.SeedSequence([seed, b]).generate_state(
            2, np.uint32)
        gens.append(make_generator(int(lo) | int(hi) << 32, device))
    return gens


def t2drl_init_batch(generators, cfg: T2DRLCfg, *,
                     share_models: bool = False) -> dict:
    """Train state for B = ``len(generators)`` cells: cell b's
    ``t2drl_init`` from ``generators[b]``, stacked.  Models, replay
    buffers and the cache state always carry the cell axis (the cache is
    per cell in shared mode too); with ``cfg.policy ==
    "independent"`` the agents are stacked too (B learners), while
    ``"shared"`` keeps cell 0's agents, one learner for all cells.
    ``share_models=True`` gives every cell cell 0's model zoo."""
    if cfg.policy not in ("independent", "shared"):
        raise ValueError(f"unknown policy {cfg.policy!r}; "
                         "expected 'independent' or 'shared'")
    if len(generators) < 1:
        raise ValueError("num_envs must be >= 1")
    cells = [t2drl_init(g, cfg) for g in generators]
    if share_models:
        cells = [{**c, "models": cells[0]["models"]} for c in cells]
    return _stack_states(cells, shared=cfg.policy == "shared")


def _stack_states(cells: list, shared: bool = False) -> dict:
    """Single-cell train states -> one B-cell state (copies): stacked
    learners, or cell 0's agents for a ``shared`` learner."""
    ts = {"models": stack_models([c["models"] for c in cells]),
          "ebuf": stack_buffers(c["ebuf"] for c in cells),
          "fbuf": stack_buffers(c["fbuf"] for c in cells),
          "cache": _stack_cache([c["cache"] for c in cells])}
    if shared:
        ts.update(d3pg=cells[0]["d3pg"], ddqn=cells[0]["ddqn"])
    else:
        ts.update(d3pg=stack_d3pg(c["d3pg"] for c in cells),
                  ddqn=stack_ddqn(c["ddqn"] for c in cells))
    return ts


def _stack_cache(cells: list) -> dict:
    return {k: torch.stack([c[k] for c in cells]) for k in cells[0]}


def cell_state(ts: dict, cfg: T2DRLCfg, b: int) -> dict:
    """Cell b of a batched train state as a single-cell state whose
    tensors are views of the batch's: what an episode on it writes in
    place lands in the batch (take the buffers' ``ptr``/``size`` and the
    Adam steps back with ``_take_back``).  Shared agents are the batch's
    own.  The cache state's access functions return new tensors, so an
    episode's final cache comes back in its returned state."""
    shared = cfg.policy == "shared"
    return {"models": cell_of(ts["models"], b),
            "d3pg": ts["d3pg"] if shared else d3pg_learner(ts["d3pg"], b),
            "ddqn": ts["ddqn"] if shared else ddqn_learner(ts["ddqn"], b),
            "ebuf": buffer_cell(ts["ebuf"], b),
            "fbuf": buffer_cell(ts["fbuf"], b),
            "cache": cell_of(ts["cache"], b)}


def _take_back(ts: dict, b: int, cell: dict) -> None:
    """The host counters of an episode run on ``cell_state(ts, cfg, b)``:
    the buffers' ``ptr``/``size`` and the learners' Adam steps."""
    for k in ("ebuf", "fbuf"):
        set_buffer_cell(ts[k], b, cell[k])
    for k, opts in (("d3pg", ("opt_a", "opt_c")), ("ddqn", ("opt",))):
        for o in opts:
            ts[k][o]["step"] = cell[k][o]["step"]


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


def _training_steps(cfg: T2DRLCfg, episodes: int, pop=None) -> List[dict]:
    """Each episode's schedule values as host floats (of the f32 values):
    ``eps``, ``sigma`` and, under an LR warmdown, ``lr_actor`` and
    ``lr_critic``.  ``pop`` (``_validate_pop``'s (E, B) lists) adds or
    replaces values with per-member lists of B."""
    alloc, _ = _agents(cfg)
    e = torch.arange(episodes, dtype=torch.float32)
    cols = {"eps": episode_epsilon(cfg, e), "sigma": episode_sigma(cfg, e)}
    if alloc.learns and cfg.lr_schedule != "const":
        scale = episode_lr_scale(cfg, e)
        cols["lr_actor"] = cfg.lr_actor * scale
        cols["lr_critic"] = cfg.lr_critic * scale
    vals = {k: v.tolist() for k, v in cols.items()}
    vals.update(pop or {})
    return [{k: v[i] for k, v in vals.items()} for i in range(episodes)]


def _update_aux(step: dict, mask=None) -> dict:
    """Reserved minibatch auxiliaries for Agent.update (DESIGN.md §12):
    the active-user mask and the schedule-driven learning rates."""
    aux = {} if mask is None else {"mask": mask}
    if "lr_actor" in step:
        aux.update(lr_actor=step["lr_actor"], lr_critic=step["lr_critic"])
    return aux


def _slot_updates(alloc, cfg: T2DRLCfg, state, generator, step: dict,
                  sample, mask=None, tap: bool = False):
    """``updates_per_slot`` sample-and-update steps of the allocator, each
    on its own minibatch ``sample(generator)``.  ``generator`` is one
    generator, or the B learners' (the stacked agent).  ``tap=True``
    (telemetry) returns ``(state, metrics)``, the updates' diagnostics
    combined over the slot's updates."""
    ms = []
    for _ in range(cfg.updates_per_slot):
        batch = sample(generator)
        state, m = alloc.update(state, {**batch, **_update_aux(step, mask)},
                                generator)
        ms.append(m)
    if not tap:
        return state
    return state, (ms[0] if len(ms) == 1 else combine_updates(ms))


# -- the episode ------------------------------------------------------------------

_SLOT_COLS = ("r", "hit", "G", "delay", "quality", "viol")


def _record_slot(cols: dict, ec: EnvCfg, r, m, mask=None) -> None:
    """Append one slot's reward and metrics (per cell for B cells) to the
    episode's columns."""
    cols["r"].append(r)
    cols["hit"].append(masked_mean(m["cached"], mask))
    cols["G"].append(masked_mean(m["G"], mask))
    cols["delay"].append(masked_mean(m["d_tl"], mask))
    cols["quality"].append(masked_mean(m["quality"], mask))
    cols["viol"].append(masked_mean((m["d_tl"] > ec.tau).to(torch.float32),
                                    mask))


def _episode_stats(cols: dict, storage_viols: list) -> dict:
    """The eight episode stats (``STAT_KEYS``) from the slot columns and
    the frames' storage violations, as device tensors: 0-dim, or (B,) per
    cell."""
    # slots last: each cell's row is reduced alone, in an order that does
    # not depend on how many cells share the call
    col = {k: torch.stack(v, dim=-1) for k, v in cols.items()}
    return {"episode_reward": torch.sum(col["r"], dim=-1),
            "mean_reward": torch.mean(col["r"], dim=-1),
            "hit_ratio": torch.mean(col["hit"], dim=-1),
            "utility": torch.mean(col["G"], dim=-1),
            "delay": torch.mean(col["delay"], dim=-1),
            "quality": torch.mean(col["quality"], dim=-1),
            "deadline_viol": torch.mean(col["viol"], dim=-1),
            "storage_viol": torch.mean(torch.stack(storage_viols, dim=-1),
                                       dim=-1)}


def _storage_viol(rho, models: ModelParams, ec: EnvCfg):
    return (torch.sum(rho * models.c, dim=-1) > ec.C).to(torch.float32)


def _stack_items(items: list, dim: int = 0) -> dict:
    return {k: torch.stack([it[k] for it in items], dim=dim)
            for k in items[0]}


class _Tap:
    """One tapped update stream of an episode (telemetry): each gated
    update site adds the update's metrics, or ``zero`` where the gate
    stayed shut, with its 0/1 ``did`` flag (a host bool: the gates are
    host counters); ``reduce`` gives the reference's ``diag/...``
    entries."""

    def __init__(self, zero: dict):
        self.zero, self.ms, self.did = zero, [], []

    def add(self, m, did: bool) -> None:
        self.ms.append(m if did else self.zero)
        self.did.append(float(did))

    def reduce(self, prefix: str) -> dict:
        dev = next(iter(self.zero.values())).device
        if not self.ms:                  # no update site (one frame)
            return {**{prefix + k: v for k, v in self.zero.items()},
                    prefix + "updates": torch.zeros((), device=dev)}
        stacked = {k: torch.stack([m[k] for m in self.ms])
                   for k in self.zero}
        did = torch.tensor(self.did, dtype=torch.float32, device=dev)
        return reduce_update_diag(stacked, did, prefix=prefix)


def _telemetry(stats: dict, cfg: T2DRLCfg, taps: dict, ebuf, fbuf,
               train: bool, B: Optional[int] = None,
               shared: bool = False) -> dict:
    """The episode's telemetry added to its stats: the taps' ``diag/``
    (allocator) and ``diag/ddqn_`` (cacher) reductions and, with
    ``cfg.obs.replay``, the replay occupancy.  For B cells every diag
    entry leads with the (B,) cell axis: the shared learner's are
    broadcast, the stacked learners' already carry it but for the update
    counts."""
    diag = {}
    for prefix, tap in taps.items():
        if tap is not None:
            diag.update(tap.reduce(prefix))
    if B is not None:
        diag = {k: (v.expand((B,) + tuple(v.shape))
                    if shared or v.dim() == 0 else v)
                for k, v in diag.items()}
    stats.update(diag)
    if train and cfg.obs.replay_on:
        occ = {**buffer_occupancy(ebuf, "ebuf", cfg.d3pg_cfg().buffer),
               **buffer_occupancy(fbuf, "fbuf", cfg.ddqn_cfg().buffer)}
        stats.update({"diag/" + k: v for k, v in occ.items()})
    return stats


def _taps(alloc, cacher, train: bool, dev, B: Optional[int] = None) -> dict:
    """The episode's update taps: the allocator's and the cacher's where
    they were built with ``diag`` (``cfg.obs.learner``) and the episode
    trains; zeros stacked to B learners for the fused core."""
    def tap(agent):
        if not train or agent.diag_zero is None:
            return None
        zero = agent.diag_zero(dev)
        return _Tap(zero if B is None else broadcast_diag(zero, B))
    return {"diag/": tap(alloc), "diag/ddqn_": tap(cacher)}


def _episode_core(ts: dict, cfg: T2DRLCfg, generator: torch.Generator,
                  step: dict, *, train: bool = True, mask=None, mods=None):
    """One episode of Algorithm 1 for a single cell, with the reference's
    semantics (module docstring).  ``step`` holds the episode's schedule
    values (``eps``, ``sigma``, optional ``lr_*``) as host floats;
    ``mask`` an optional (U,) active-user mask; ``mods`` an optional
    unbatched ``ScenarioSchedule`` whose slices reach the env at every
    draw.  ``train=False`` acts only: no replay write, no update.  Learned
    state, buffers included, is updated in place; a classical cacher's
    state advances once a frame on the frame's requests
    (``step_frame``) and comes back in the returned state.  Returns ``(ts,
    stats)``, the eight stats as 0-dim device tensors, plus the telemetry
    of ``cfg.obs`` (no host read inside the episode; the update gates
    read host counters only)."""
    ec = cfg.env
    d3, dq = cfg.d3pg_cfg(), cfg.ddqn_cfg()
    alloc, cacher = _agents(cfg)
    stateful = cacher.step_frame is not None
    models: ModelParams = ts["models"]
    alloc_state, cacher_state = ts["d3pg"], ts["ddqn"]
    cache = ts["cache"]
    ebuf, fbuf = ts["ebuf"], ts["fbuf"]
    cap_e = d3.buffer
    taps = _taps(alloc, cacher, train, models.c.device)
    env = env_reset(generator, ec, schedule_slot_mod(mods, 0))
    cols = {k: [] for k in _SLOT_COLS}
    gammas, a_ints, r_frames, storage_viols = [], [], [], []

    def sample(g):
        return buffer_sample(ebuf, g, d3.batch)

    for t in range(ec.T):
        env = env_advance_frame(env, ec, schedule_frame_P(mods, t),
                                schedule_slot_mod(mods, t * ec.K))
        gamma_t = env.gamma_idx
        a_int, rho = cacher.act(cache if stateful else cacher_state,
                                FrameObs(gamma_t, models), generator, step)
        env = env_set_cache(env, rho)
        size0 = ebuf["size"]
        items, frame_r, reqs = [], [], []
        s = observe(env, ec, models, mask) if alloc.learns else None
        for k in range(ec.K):
            b, xi = alloc.act(alloc_state, SlotObs(s, env, models, mask),
                              generator, step)
            env1, r, m = env_step_slot(
                env, ec, models, b, xi, mask,
                schedule_slot_mod(mods, t * ec.K + k + 1))
            frame_r.append(r)
            _record_slot(cols, ec, r, m, mask)
            reqs.append(env.req)
            if alloc.learns:
                s1 = observe(env1, ec, models, mask)
                items.append({"s": s, "a": torch.cat([b, xi]), "r": r,
                              "s1": s1, "req": env.req, "rho": env.rho,
                              "req1": env1.req, "rho1": env1.rho})
                # transitions stored so far = frame-start size + slot
                # count (the write itself is batched at frame end)
                gate = (train and min(size0 + k + 1, cap_e) > cfg.warmup
                        and size0 > 0)
                metrics = None
                if gate:
                    out = _slot_updates(alloc, cfg, alloc_state, generator,
                                        step, sample, mask,
                                        tap=taps["diag/"] is not None)
                    alloc_state, metrics = (out if taps["diag/"]
                                            else (out, None))
                if taps["diag/"] is not None:
                    taps["diag/"].add(metrics, gate)
                s = s1
            env = env1
        if alloc.learns and train:
            ebuf = buffer_add_many(ebuf, _stack_items(items))
        if stateful:
            cache = cacher.step_frame(cache, torch.stack(reqs), models, mask)
        # frame reward (32): mean slot reward minus the storage penalty
        # (erratum-corrected sign, DESIGN.md §8)
        storage_viol = _storage_viol(rho, models, ec)
        r_frames.append(torch.mean(torch.stack(frame_r))
                        - storage_viol * ec.Xi)
        gammas.append(gamma_t)
        a_ints.append(a_int)
        storage_viols.append(storage_viol)

    # DDQN frame transitions (gamma_t, a_t, r_t, gamma_{t+1}) for t < T-1
    if cacher.learns and train:
        for t in range(ec.T - 1):
            fbuf = buffer_add(fbuf, {"s": gammas[t], "a": a_ints[t],
                                     "r": r_frames[t], "s1": gammas[t + 1]})
            gate = fbuf["size"] > dq.batch
            metrics = None
            if gate:
                batch = buffer_sample(fbuf, generator, dq.batch)
                cacher_state, metrics = cacher.update(cacher_state, batch,
                                                      generator)
            if taps["diag/ddqn_"] is not None:
                taps["diag/ddqn_"].add(metrics, gate)

    ts = {"models": models, "d3pg": alloc_state, "ddqn": cacher_state,
          "ebuf": ebuf, "fbuf": fbuf, "cache": cache}
    return ts, _telemetry(_episode_stats(cols, storage_viols), cfg, taps,
                          ebuf, fbuf, train)


def _pool(batch: dict) -> dict:
    """(B, n, ...) per-cell samples -> one (B*n, ...) minibatch."""
    return {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in batch.items()}


def _episode_core_shared(ts: dict, cfg: T2DRLCfg, generators, step: dict, *,
                         train: bool = True, masks=None, mods=None):
    """One episode of B cells in lockstep feeding their own replay buffers
    and ONE shared learner (the reference's ``_episode_core_shared``): the
    learner acts for all cells at once (``batch_act``, else the
    batch-transparent ``act``) and takes one step a slot on a minibatch
    pooled from ``d3.batch // B`` rows of each cell's buffer (the DDQN
    likewise, ``dq.batch // B`` per cell), so its cost per step does not
    grow with B.  Cell b's env draws from ``generators[b]``; the learner's
    actions, minibatches and chains from the driver generator, cell 0's.
    ``masks``: optional (B, U); ``mods``: a ``ScenarioSchedule`` with
    (B,)-leading leaves.  A classical cacher's state is per cell, (B, M),
    and one batched replay a frame advances all B.  Returns ``(ts,
    stats)`` with (B,) stats; the shared learner's telemetry is broadcast
    to (B,)."""
    ec = cfg.env
    d3, dq = cfg.d3pg_cfg(), cfg.ddqn_cfg()
    alloc, cacher = _agents(cfg)
    stateful = cacher.step_frame is not None
    act = alloc.batch_act or alloc.act
    cact = cacher.batch_act or cacher.act
    models: ModelParams = ts["models"]
    alloc_state, cacher_state = ts["d3pg"], ts["ddqn"]
    cache = ts["cache"]
    ebuf, fbuf = ts["ebuf"], ts["fbuf"]
    cap_e, B = d3.buffer, len(generators)
    taps = _taps(alloc, cacher, train, models.c.device)
    driver = generators[0]
    env = env_reset_batch(generators, ec, schedule_slot_mod(mods, 0))
    n_slot, n_frame = max(1, d3.batch // B), max(1, dq.batch // B)
    row_masks = (None if masks is None
                 else masks.repeat_interleave(n_slot, dim=0))
    cols = {k: [] for k in _SLOT_COLS}
    gammas, a_ints, r_frames, storage_viols = [], [], [], []

    def sample(g):
        return _pool(buffer_sample_batch(ebuf, g, n_slot))

    for t in range(ec.T):
        env = env_advance_frame(env, ec, schedule_frame_P(mods, t),
                                schedule_slot_mod(mods, t * ec.K))
        gamma_t = env.gamma_idx
        a_int, rho = cact(cache if stateful else cacher_state,
                          FrameObs(gamma_t, models), driver, step)
        env = env_set_cache(env, rho)
        size0 = list(ebuf["size"])
        items, frame_r, reqs = [], [], []
        s = observe(env, ec, models, masks) if alloc.learns else None
        for k in range(ec.K):
            b, xi = act(alloc_state, SlotObs(s, env, models, masks), driver,
                        step)
            env1, r, m = env_step_slot(
                env, ec, models, b, xi, masks,
                schedule_slot_mod(mods, t * ec.K + k + 1))
            frame_r.append(r)
            _record_slot(cols, ec, r, m, masks)
            reqs.append(env.req)
            if alloc.learns:
                s1 = observe(env1, ec, models, masks)
                items.append({"s": s, "a": torch.cat([b, xi], dim=-1),
                              "r": r, "s1": s1, "req": env.req,
                              "rho": env.rho, "req1": env1.req,
                              "rho1": env1.rho})
                stored = sum(min(sz + k + 1, cap_e) for sz in size0)
                gate = train and stored > cfg.warmup and min(size0) > 0
                metrics = None
                if gate:
                    out = _slot_updates(alloc, cfg, alloc_state, driver,
                                        step, sample, row_masks,
                                        tap=taps["diag/"] is not None)
                    alloc_state, metrics = (out if taps["diag/"]
                                            else (out, None))
                if taps["diag/"] is not None:
                    taps["diag/"].add(metrics, gate)
                s = s1
            env = env1
        if alloc.learns and train:
            ebuf = buffer_add_many_batch(ebuf, _stack_items(items, dim=1))
        if stateful:
            cache = cacher.step_frame(cache, torch.stack(reqs, dim=1),
                                      models, masks)
        storage_viol = _storage_viol(rho, models, ec)
        r_frames.append(torch.mean(torch.stack(frame_r), dim=0)
                        - storage_viol * ec.Xi)
        gammas.append(gamma_t)
        a_ints.append(a_int)
        storage_viols.append(storage_viol)

    if cacher.learns and train:
        for t in range(ec.T - 1):
            fbuf = buffer_add_batch(fbuf, {"s": gammas[t], "a": a_ints[t],
                                           "r": r_frames[t],
                                           "s1": gammas[t + 1]})
            gate = sum(fbuf["size"]) > dq.batch
            metrics = None
            if gate:
                batch = _pool(buffer_sample_batch(fbuf, driver, n_frame))
                cacher_state, metrics = cacher.update(cacher_state, batch,
                                                      driver)
            if taps["diag/ddqn_"] is not None:
                taps["diag/ddqn_"].add(metrics, gate)

    ts = {"models": models, "d3pg": alloc_state, "ddqn": cacher_state,
          "ebuf": ebuf, "fbuf": fbuf, "cache": cache}
    return ts, _telemetry(_episode_stats(cols, storage_viols), cfg, taps,
                          ebuf, fbuf, train, B=B, shared=True)


def _device_step(step: dict, device) -> dict:
    """Per-learner step values (lists of B) as the stacked closures take
    them, moved to the device once an episode: ``sigma``, the learning
    rates and ``shape_hit`` become (B,) tensors; ``eps`` stays a host list
    (the epsilon-greedy draw is skipped for a learner whose eps is 0)."""
    return {k: (torch.tensor(v, dtype=torch.float32, device=device)
                if isinstance(v, (list, tuple)) and k != "eps" else v)
            for k, v in step.items()}


def _episode_core_fused(ts: dict, cfg: T2DRLCfg, generators, step: dict, *,
                        train: bool = True, masks=None, mods=None):
    """One episode of B INDEPENDENT learners as one fused program (the
    reference's ``_episode_core_fused``): every learner and buffer leaf
    carries the (B,) axis, each slot's B actions are one stacked chain
    launch, each update step one stacked update (2 + 1 chain launches for
    all B) on every learner's own minibatch (one gather per leaf), and the
    frame's replay writes one indexed write per leaf.  Cell b draws from
    ``generators[b]`` exactly what the single-cell core draws, in its
    order, so each cell's episode is that core's on its generator, to
    float round-off (the batched products sum as the single ones do only
    up to rounding).

    The update gates are scalar: every cell writes K slot items a frame in
    lockstep, so the per-cell gates of the single core agree, and one
    gate over all cells runs or skips the stacked update.  ``step`` values
    may be per-learner lists of B (population training): ``eps``,
    ``sigma``, ``lr_actor``, ``lr_critic``, plus ``lr_ddqn`` (the DDQN's
    rate) and ``shape_hit`` (adds ``shape_hit * mean(hit)`` to the stored
    slot rewards and the frame reward; the stats stay unshaped).
    ``masks``: optional (B, U); ``mods``: a ``ScenarioSchedule`` with
    (B,)-leading leaves.  A classical cacher's (B, M) state advances in
    one batched replay a frame.  Returns ``(ts, stats)`` with (B,) stats;
    the stacked updates' telemetry per learner, (B,) and (B, L)."""
    ec = cfg.env
    d3, dq = cfg.d3pg_cfg(), cfg.ddqn_cfg()
    alloc0, cacher0 = _agents(cfg)
    alloc = vmap_agent(alloc0, impl="fused")
    cacher = vmap_agent(cacher0, impl="fused")
    stateful = cacher0.step_frame is not None
    models: ModelParams = ts["models"]
    alloc_state, cacher_state = ts["d3pg"], ts["ddqn"]
    cache = ts["cache"]
    ebuf, fbuf = ts["ebuf"], ts["fbuf"]
    cap_e, B = d3.buffer, len(generators)
    taps = _taps(alloc0, cacher0, train, models.c.device, B)
    step = _device_step(step, models.c.device)
    shape_hit = step.get("shape_hit")
    env = env_reset_batch(generators, ec, schedule_slot_mod(mods, 0))
    cols = {k: [] for k in _SLOT_COLS}
    gammas, a_ints, r_frames, storage_viols = [], [], [], []

    def sample(gens):
        return buffer_sample_stacked(ebuf, gens, d3.batch)

    for t in range(ec.T):
        env = env_advance_frame(env, ec, schedule_frame_P(mods, t),
                                schedule_slot_mod(mods, t * ec.K))
        gamma_t = env.gamma_idx
        with profiling.span("t2drl.cacher_act"):
            a_int, rho = cacher.act(cache if stateful else cacher_state,
                                    FrameObs(gamma_t, models), generators,
                                    step)
        env = env_set_cache(env, rho)
        size0 = list(ebuf["size"])
        items, frame_r, reqs = [], [], []
        s = observe(env, ec, models, masks) if alloc0.learns else None
        for k in range(ec.K):
            with profiling.span("t2drl.act"):
                b, xi = alloc.act(alloc_state,
                                  SlotObs(s, env, models, masks),
                                  generators, step)
            with profiling.span("env.step_slot"):
                env1, r, m = env_step_slot(
                    env, ec, models, b, xi, masks,
                    schedule_slot_mod(mods, t * ec.K + k + 1))
            frame_r.append(r)
            _record_slot(cols, ec, r, m, masks)
            reqs.append(env.req)
            if alloc0.learns:
                s1 = observe(env1, ec, models, masks)
                r_store = (r if shape_hit is None
                           else r + shape_hit * cols["hit"][-1])
                items.append({"s": s, "a": torch.cat([b, xi], dim=-1),
                              "r": r_store, "s1": s1, "req": env.req,
                              "rho": env.rho, "req1": env1.req,
                              "rho1": env1.rho})
                gate = train and all(min(sz + k + 1, cap_e) > cfg.warmup
                                     and sz > 0 for sz in size0)
                metrics = None
                if gate:
                    with profiling.span("t2drl.slot_updates"):
                        out = _slot_updates(alloc, cfg, alloc_state,
                                            generators, step, sample, masks,
                                            tap=taps["diag/"] is not None)
                    alloc_state, metrics = (out if taps["diag/"]
                                            else (out, None))
                if taps["diag/"] is not None:
                    taps["diag/"].add(metrics, gate)
                s = s1
            env = env1
        if alloc0.learns and train:
            with profiling.span("replay.add"):
                ebuf = buffer_add_many_stacked(ebuf,
                                               _stack_items(items, dim=1))
        if stateful:
            cache = cacher0.step_frame(cache, torch.stack(reqs, dim=1),
                                       models, masks)
        storage_viol = _storage_viol(rho, models, ec)
        # slots last, as in _episode_stats: each cell's mean alone
        r_frame = torch.mean(torch.stack(frame_r, dim=-1), dim=-1) \
            - storage_viol * ec.Xi
        if shape_hit is not None:
            r_frame = r_frame + shape_hit * torch.mean(
                torch.stack(cols["hit"][-ec.K:], dim=-1), dim=-1)
        r_frames.append(r_frame)
        gammas.append(gamma_t)
        a_ints.append(a_int)
        storage_viols.append(storage_viol)

    if cacher0.learns and train:
        with profiling.span("t2drl.ddqn_updates"):
            for t in range(ec.T - 1):
                fbuf = buffer_add_batch(fbuf, {"s": gammas[t],
                                               "a": a_ints[t],
                                               "r": r_frames[t],
                                               "s1": gammas[t + 1]})
                gate = all(sz > dq.batch for sz in fbuf["size"])
                metrics = None
                if gate:
                    batch = buffer_sample_stacked(fbuf, generators,
                                                  dq.batch)
                    if "lr_ddqn" in step:
                        batch["lr"] = step["lr_ddqn"]
                    cacher_state, metrics = cacher.update(cacher_state,
                                                          batch, generators)
                if taps["diag/ddqn_"] is not None:
                    taps["diag/ddqn_"].add(metrics, gate)

    ts = {"models": models, "d3pg": alloc_state, "ddqn": cacher_state,
          "ebuf": ebuf, "fbuf": fbuf, "cache": cache}
    return ts, _telemetry(_episode_stats(cols, storage_viols), cfg, taps,
                          ebuf, fbuf, train, B=B)


def _is_per_learner(v) -> bool:
    return isinstance(v, (list, tuple)) or (torch.is_tensor(v) and v.dim())


def _stack_cells(values: list):
    """Per-cell stats -> (B,)-leading: tensors stacked, host values listed."""
    if torch.is_tensor(values[0]):
        return torch.stack(values)
    return list(values)


def _episode_batch(ts: dict, cfg: T2DRLCfg, generators, step: dict, *,
                   train: bool = True, masks=None, mods=None):
    """One episode across B = ``len(generators)`` cells.  ``"shared"``
    runs the shared-learner core; ``"independent"`` the fused core
    (``independent_impl="fused"``, for B > 1 or per-learner step values)
    or the single-cell core on each cell in turn, on views of the batch
    (``"vmap"``, and B = 1), the fused core's reference.  ``mods``: a
    ``ScenarioSchedule`` with (B,)-leading leaves.  Returns ``(ts,
    stats)`` with (B,) device stats; ``ts`` is a new dict (its cache the
    episode's final one), the argument's learned state and buffers
    updated in place."""
    if cfg.policy == "shared":
        return _episode_core_shared(ts, cfg, generators, step, train=train,
                                    masks=masks, mods=mods)
    if cfg.independent_impl not in ("fused", "vmap"):
        raise ValueError(
            f"unknown independent_impl {cfg.independent_impl!r}; "
            "expected 'fused' or 'vmap'")
    pop_step = any(_is_per_learner(v) for v in step.values())
    if pop_step and cfg.independent_impl != "fused":
        raise ValueError("per-cell (population) schedules require "
                         "independent_impl='fused'")
    if cfg.independent_impl == "fused" and (len(generators) > 1 or pop_step):
        return _episode_core_fused(ts, cfg, generators, step, train=train,
                                   masks=masks, mods=mods)
    cells = [cell_state(ts, cfg, b) for b in range(len(generators))]
    stats, caches = [], []
    for b, (cell, g) in enumerate(zip(cells, generators)):
        cell, st = _episode_core(cell, cfg, g, cell_of(step, b),
                                 train=train, mask=cell_of(masks, b),
                                 mods=cell_of(mods, b))
        _take_back(ts, b, cell)
        stats.append(st)
        caches.append(cell["cache"])
    return ({**ts, "cache": _stack_cache(caches)},
            {k: _stack_cells([st[k] for st in stats]) for k in stats[0]})


def _stats_to_host(stats: dict) -> dict:
    """One host read for an episode's stats: each tensor as a float or
    (nested) lists (one per cell, and per chain step for
    ``denoise_mag``); host values (the replay occupancy) as they are."""
    tensors = [v for v in stats.values() if torch.is_tensor(v)]
    flat = (torch.cat([v.detach().reshape(-1).to(torch.float32)
                       for v in tensors]).tolist() if tensors else [])
    out, i = {}, 0
    for k, v in stats.items():
        if torch.is_tensor(v):
            n = v.numel()
            out[k] = (flat[i] if v.dim() == 0
                      else np.asarray(flat[i:i + n]).reshape(
                          tuple(v.shape)).tolist())
            i += n
        else:
            out[k] = v
    return out


_POP_KEYS = ("eps", "sigma", "lr_actor", "lr_critic", "lr_ddqn", "shape_hit")


def _validate_pop(pop, cfg: T2DRLCfg, B: int, E: int):
    """A population-schedule dict as (E, B) lists of host floats, as the
    reference's ``_validate_pop``: keys among ``_POP_KEYS``, values (B,)
    (one per member, every episode) or (E, B); only the fused independent
    core takes them.  A missing partner of ``lr_actor``/``lr_critic`` is
    filled with the configured rate."""
    if pop is None:
        return None
    unknown = set(pop) - set(_POP_KEYS)
    if unknown:
        raise ValueError(f"unknown population keys {sorted(unknown)}; "
                         f"expected a subset of {_POP_KEYS}")
    if cfg.policy != "independent" or cfg.independent_impl != "fused":
        raise ValueError(
            "population schedules require policy='independent' and "
            "independent_impl='fused' (DESIGN.md §13)")
    out = {}
    for k, v in pop.items():
        v = np.asarray(torch.as_tensor(v, dtype=torch.float32).cpu(),
                       np.float32)
        if v.ndim == 1:
            v = np.broadcast_to(v[None], (E,) + v.shape)
        if v.shape != (E, B):
            raise ValueError(f"population key {k!r} must be (B,)=({B},) or "
                             f"(E, B)=({E}, {B}); got {v.shape}")
        out[k] = v.tolist()
    if ("lr_actor" in out) != ("lr_critic" in out):
        k_have = "lr_actor" if "lr_actor" in out else "lr_critic"
        k_miss = "lr_critic" if k_have == "lr_actor" else "lr_actor"
        const = cfg.lr_critic if k_miss == "lr_critic" else cfg.lr_actor
        out[k_miss] = np.full((E, B), const, np.float32).tolist()
    return out


def _broadcast_mods(mods: Optional[ScenarioSchedule], num_envs: int):
    """An unbatched schedule with a leading (num_envs,) cell axis (views);
    a per-cell one is checked and passed through, ``None`` too."""
    if mods is None:
        return None
    if mods.h_scale.dim() == 2:
        if mods.h_scale.shape[0] != num_envs:
            raise ValueError(
                f"per-cell schedule was built for {mods.h_scale.shape[0]} "
                f"cells but num_envs={num_envs}; rebuild with "
                f"build_scenario(..., num_envs={num_envs})")
        return mods
    return ScenarioSchedule(*(x.expand((num_envs,) + tuple(x.shape))
                              for x in mods))


def run_training(ts: dict, cfg: T2DRLCfg, generators, episodes: int,
                 masks=None, mods=None, *, train: bool = True, pop=None,
                 log_every: int = 0, callback=None, writer=None):
    """``episodes`` batched episodes (``_episode_batch``) of the B cells of
    ``ts`` with their generators, on the episode schedules (and ``pop``'s
    per-member ones, see ``_validate_pop``); ``mods`` a scenario schedule
    (unbatched leaves are broadcast to the B cells) replayed every
    episode.  Returns ``(ts, history)``: per key, a list of episodes of
    lists of B host floats (one host read per episode).
    ``log_every``/``callback`` see the means over cells; ``writer``
    receives a ``train_chunk`` record per chunk (``_run_episodes``)."""
    B = len(generators)
    pop = _validate_pop(pop, cfg, B, episodes)
    mods = _broadcast_mods(mods, B)
    state = {"ts": ts}

    def episode(step):
        state["ts"], stats = _episode_batch(state["ts"], cfg, generators,
                                            step, train=train, masks=masks,
                                            mods=mods)
        return stats

    history = _run_episodes(episode, _training_steps(cfg, episodes, pop),
                            log_every, callback, writer)
    return state["ts"], history


def run_episode(ts: dict, cfg: T2DRLCfg, generator: torch.Generator, eps,
                sigma, *, train: bool = True,
                mods: Optional[ScenarioSchedule] = None):
    """One episode of Algorithm 1 for a single cell (``t2drl_init``'s
    layout) at exploration ``eps`` and ``sigma``, its draws from
    ``generator``; ``mods`` an optional unbatched ``ScenarioSchedule``.
    The state is updated in place (``_episode_core``).  Returns ``(ts,
    stats)``, the stats 0-dim device tensors."""
    return _episode_core(ts, cfg, generator, {"eps": eps, "sigma": sigma},
                         train=train, mods=mods)


# -- cells sharded over ranks (DESIGN.md §13) ---------------------------------

def _cell_leaves(ts: dict) -> list:
    """Every (B,)-leading tensor of a batched state with stacked
    learners, in one fixed order: the zoo, the learners' parameters and
    Adam moments, the buffers' data, the cache state."""
    out = list(ts["models"])
    for k in ("d3pg", "ddqn"):
        for name in sorted(ts[k]):
            v = ts[k][name]
            out += ([q.data for q in v.parameters()]
                    if isinstance(v, torch.nn.Module) else v["mu"] + v["nu"])
    for k in ("ebuf", "fbuf"):
        out += [ts[k]["data"][n] for n in sorted(ts[k]["data"])]
    return out + [ts["cache"][n] for n in sorted(ts["cache"])]


def _cell_hosts(ts: dict) -> dict:
    """The host counters of a batched state: per-cell buffer ``ptr`` and
    ``size`` lists, and the learners' Adam steps (one for all)."""
    return {"buffers": {k: (list(ts[k]["ptr"]), list(ts[k]["size"]))
                        for k in ("ebuf", "fbuf")},
            "steps": {(k, o): ts[k][o]["step"] for k, opts in
                      (("d3pg", ("opt_a", "opt_c")), ("ddqn", ("opt",)))
                      for o in opts}}


def _gather_cells(ts: dict, local: dict, group, history=None):
    """Write every rank's cells of ``local`` (this rank's contiguous
    slice, rank order) into the whole state ``ts``: the tensors in one
    byte buffer gathered over ``group`` (device tensors under NCCL, a
    host copy under gloo), the host counters and ``history`` (per key,
    episodes of per-cell lists) as objects.  Returns (the whole history,
    bytes gathered)."""
    whole, mine = _cell_leaves(ts), _cell_leaves(local)
    n = dist.get_world_size(group)
    B_loc = mine[0].shape[0]
    for w, m in zip(whole, mine):
        if w.shape != (n * B_loc,) + m.shape[1:] or w.dtype != m.dtype:
            raise ValueError(f"a local leaf {tuple(m.shape)} {m.dtype} does "
                             f"not tile its whole leaf {tuple(w.shape)} "
                             f"{w.dtype} over {n} ranks")
    chunks = []                 # each leaf's bytes, padded to 8
    for m in mine:
        b = m.detach().reshape(-1).view(torch.uint8)
        chunks += [b, b.new_zeros((-b.numel()) % 8)]
    buf = torch.cat(chunks)
    if dist.get_backend(group) == "nccl":
        parts = torch.empty((n,) + buf.shape, dtype=buf.dtype,
                            device=buf.device)
        dist.all_gather_into_tensor(parts, buf, group=group)
    else:
        host = buf.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
    for r in range(n):
        off, rows = 0, slice(r * B_loc, (r + 1) * B_loc)
        for w, m in zip(whole, mine):
            nb = m.numel() * m.element_size()
            w[rows].copy_(parts[r][off:off + nb].view(m.dtype)
                          .reshape(m.shape))
            off += nb + (-nb) % 8
    hosts, objs = _cell_hosts(local), [None] * n
    dist.all_gather_object(objs, (hosts, history), group=group)
    steps = {tuple(sorted(o[0]["steps"].items())) for o in objs}
    if len(steps) != 1:
        raise RuntimeError(f"the ranks' learners stepped apart: {steps}")
    for k in ("ebuf", "fbuf"):
        ts[k]["ptr"] = [p for o in objs for p in o[0]["buffers"][k][0]]
        ts[k]["size"] = [z for o in objs for z in o[0]["buffers"][k][1]]
    for (k, o), step in hosts["steps"].items():
        ts[k][o]["step"] = step
    if history is not None:
        history = {k: [[c for o in objs for c in o[1][k][e]]
                       for e in range(len(v))] for k, v in history.items()}
    return history, buf.numel() * n


def run_training_sharded(ts: dict, cfg: T2DRLCfg, generators, episodes: int,
                         masks=None, *, train: bool = True, pop=None,
                         mesh=None, mods=None):
    """``run_training`` with the B independent cells sharded over the
    ranks of a 1-D ``("cells",)`` mesh (``mesh``, default
    ``repro_torch.launch.mesh.make_cells_mesh()``): the reference's
    ``run_training_sharded``, one process a rank (SPMD).

    Every rank calls it with the same whole state ``ts`` and the B global
    ``cell_generators(cfg.seed, B)``.  Rank r takes its contiguous slice
    of B/n cells (state leaves, Adam moments, buffers with their
    ``ptr``/``size``, ``masks``, ``pop``'s columns and generators), runs
    the fused episodes on that slice alone, with no communication during
    training, and the schedules of the global episodes and B (``pop`` is
    validated against B).  At the end the slices are gathered over the
    mesh's group into ``ts`` (written in place) on every rank, so every
    rank returns the whole ``(ts, history)`` that ``run_training`` gives
    on all B cells: the same values, history (episodes, B).  The
    generators of other ranks' cells are not advanced on this rank.

    Refusals, as the reference's: ``policy="independent"`` with
    ``independent_impl="fused"`` only; B divisible by the mesh's size; no
    ``mods``."""
    if cfg.policy != "independent" or cfg.independent_impl != "fused":
        raise ValueError("run_training_sharded requires policy="
                         "'independent' and independent_impl='fused'")
    if mods is not None:
        raise ValueError("run_training_sharded takes no scenario schedule "
                         "(mods), as the reference's does not")
    B = len(generators)
    if mesh is None:
        from repro_torch.launch.mesh import make_cells_mesh
        mesh = make_cells_mesh()
    n = mesh.size()
    if B % n:
        raise ValueError(f"num_envs={B} must be divisible by the mesh's "
                         f"{n} devices")
    pop = _validate_pop(pop, cfg, B, episodes)
    lo = mesh.get_local_rank("cells") * (B // n)
    mine = slice(lo, lo + B // n)
    gens = list(generators[mine])
    local = _stack_states([cell_state(ts, cfg, b)
                           for b in range(mine.start, mine.stop)])
    masks = None if masks is None else masks[mine]
    if pop is not None:
        pop = {k: [row[mine] for row in v] for k, v in pop.items()}
    # run_training's core at the global B: the fused one for B > 1
    core = _episode_core_fused if B > 1 else _episode_batch
    state = {"ts": local}

    def episode(step):
        state["ts"], stats = core(state["ts"], cfg, gens, step,
                                  train=train, masks=masks)
        return stats

    history = _run_episodes(episode, _training_steps(cfg, episodes, pop),
                            0, None)
    history, _ = _gather_cells(ts, state["ts"], mesh.get_group("cells"),
                               history)
    return ts, history


def _mean(v) -> float:
    """Mean of a host value: a float, or every number of nested lists."""
    return float(np.mean(v)) if isinstance(v, list) else v


def _chunk_summary(rows: Dict[str, list]) -> dict:
    """A chunk of history for its ``train_chunk`` record, as the
    reference's ``_chunk_summary``: per key the mean over episodes and
    cells, but ``*denoise_mag`` keeps its chain axis (an L-vector)."""
    out = {}
    for k, v in rows.items():
        a = np.asarray(v, np.float64)
        if k.endswith("denoise_mag") and a.ndim >= 2:
            out[k] = a.reshape(-1, a.shape[-1]).mean(axis=0).tolist()
        else:
            out[k] = float(a.mean())
    return out


def _run_episodes(episode, steps: List[dict], log_every: int, callback,
                  writer=None):
    """``episode(step)`` for each episode's schedule values, its stats read
    to the host once; returns the history (per key, a list over
    episodes).  ``log_every`` prints the reference's progress line and
    ``callback(episode, stats)`` receives the stats, means over cells
    (and chain steps).  ``writer`` gets a ``train_chunk`` record (episode
    cursor, wall s, ``_chunk_summary``) after every chunk: ``log_every``
    episodes (1 with only a callback), else the whole run, as the
    reference chunks its scan."""
    history: Dict[str, list] = {}
    chunk = (log_every or 1) if (log_every or callback) else len(steps)
    ep0, t0 = 0, time.perf_counter()
    for ep, step in enumerate(steps):
        host = _stats_to_host(episode(step))
        for k, v in host.items():
            history.setdefault(k, []).append(v)
        shown = {k: _mean(v) for k, v in host.items()}
        if log_every and (ep + 1) % log_every == 0:
            print(progress_line(ep + 1, shown), flush=True)
        if callback is not None:
            callback(ep, shown)
        if writer is not None and (ep + 1 - ep0 == chunk
                                   or ep + 1 == len(steps)):
            writer.write("train_chunk", episode=ep + 1,
                         episodes=len(steps),
                         wall_s=time.perf_counter() - t0,
                         stats=_chunk_summary({k: v[ep0:] for k, v in
                                               history.items()}))
            ep0, t0 = ep + 1, time.perf_counter()
    return history


def train_t2drl(cfg: T2DRLCfg, *, episodes: Optional[int] = None,
                num_envs: int = 1, user_counts: Optional[Sequence[int]] = None,
                share_models: bool = False, log_every: int = 0,
                callback=None, mods: Optional[ScenarioSchedule] = None,
                writer=None, device=None):
    """Train ``num_envs`` edge cells for ``episodes`` episodes (default
    ``cfg.episodes``) on ``resolve_device(device)``: the card unless
    ``device="cpu"`` is passed.

    One cell (``num_envs=1``, ``policy="independent"``): everything is
    drawn from one generator seeded with ``cfg.seed``, the initial state
    (``t2drl_init``) then each episode's env, actions, minibatches and
    chains in order.  B cells: ``cell_generators(cfg.seed, B)``, cell b's
    state and episodes from generator b; ``cfg.policy`` picks B
    independent learners (``independent_impl``: "fused" or "vmap") or one
    shared learner (cell 0's init).  ``user_counts`` gives each cell its
    active users (masks); ``share_models`` gives every cell cell 0's zoo.
    ``mods``: a ``ScenarioSchedule`` (``repro_torch.scenarios.
    build_scenario``) on the same device, unbatched leaves broadcast to
    every cell, (num_envs,)-leading ones per cell.  ``log_every`` prints a
    progress line every N episodes; ``callback(episode, stats)`` runs
    after each episode with its stats as host floats (means over cells).
    ``writer`` (a ``repro_torch.obs.MetricWriter``): the run's manifest,
    then a ``train_chunk`` record per chunk.  ``cfg.obs`` adds the
    telemetry keys (``diag/...``) to the history.

    Returns ``(ts, history)``: the final train state (the single-cell
    layout for ``num_envs=1``, B-leading otherwise) and the per-episode
    stats, lists of host floats for ``num_envs=1`` and lists of B-lists,
    (episodes, B), otherwise."""
    if num_envs < 1:
        raise ValueError("num_envs must be >= 1")
    if cfg.policy not in ("independent", "shared"):
        raise ValueError(f"unknown policy {cfg.policy!r}; "
                         "expected 'independent' or 'shared'")
    episodes = episodes or cfg.episodes
    dev = resolve_device(device)
    masks = None
    if user_counts is not None:
        if len(user_counts) != num_envs:
            raise ValueError("user_counts must have one entry per env")
        masks = make_user_masks(cfg.env, user_counts).to(dev)
    if writer is not None:
        writer.ensure_manifest(cfg, extra={"episodes": int(episodes),
                                           "num_envs": int(num_envs)},
                               device=dev)
    if num_envs == 1 and cfg.policy == "independent":
        generator = make_generator(cfg.seed, dev)
        state = {"ts": t2drl_init(generator, cfg)}
        mask = None if masks is None else masks[0]
        mods1 = (None if mods is None else
                 cell_of(_broadcast_mods(mods, 1), 0))

        def episode(step):
            state["ts"], stats = _episode_core(state["ts"], cfg, generator,
                                               step, mask=mask, mods=mods1)
            return stats

        history = _run_episodes(episode, _training_steps(cfg, episodes),
                                log_every, callback, writer)
        return state["ts"], history
    gens = cell_generators(cfg.seed, num_envs, dev)
    ts = t2drl_init_batch(gens, cfg, share_models=share_models)
    ts, history = run_training(ts, cfg, gens, episodes, masks, mods,
                               log_every=log_every, callback=callback,
                               writer=writer)
    if num_envs == 1:               # the shared learner on one cell
        ts = cell_state(ts, cfg, 0)
        history = {k: [v[0] for v in vs] for k, vs in history.items()}
    return ts, history


# -- policy deployment (inference only, DESIGN.md §11/§12) ------------------------

def _is_batched(ts: dict) -> bool:
    return ts["models"].a1.dim() == 2


def export_policy(ts: dict, cfg: T2DRLCfg, cell: int = 0) -> dict:
    """The inference-only policy of a train state, as each agent exports
    it: ``{"actor": Denoiser|MLP}`` and ``{"ddqn": {"q": MLP}}``, keys only
    for learned components (empty for RCARS/SCHRS); a classical cacher
    exports ``{"cache": {"rho": (M,)}}``, the resident set that greedy
    serving keeps.  The modules are the train state's own, not copies.
    For a batched state, ``cell`` picks the learner (its modules are views
    of the stack's; a shared state has one learner) and the cell's cache
    (per cell in either mode)."""
    alloc, cacher = _agents(cfg)
    cache = ts["cache"]
    if _is_batched(ts):
        cache = cell_of(cache, cell)
        if cfg.policy != "shared":
            ts = {"d3pg": d3pg_learner(ts["d3pg"], cell),
                  "ddqn": ddqn_learner(ts["ddqn"], cell)}
    pol = {}
    if alloc.learns:
        pol.update(alloc.export(ts["d3pg"]))
    if cacher.learns:
        pol.update(cacher.export(ts["ddqn"]))
    elif cacher.step_frame is not None:
        pol.update(cacher.export(cache))
    return pol


def policy_init(cfg: T2DRLCfg, seed: int, device=None) -> dict:
    """A fresh inference policy on ``resolve_device(device)``: the
    ``export_policy`` of the agents' fresh states (a classical cacher's:
    the empty cache)."""
    alloc, cacher = _agents(cfg)
    g = make_generator(seed, device)
    pol = {}
    for agent in (alloc, cacher):
        if agent.learns or agent.step_frame is not None:
            pol.update(agent.export(agent.init(g)))
    return pol


def greedy_slot_action(policy, cfg: T2DRLCfg, env: EnvState,
                       models: ModelParams, generator=None, mask=None, *,
                       x_L=None, noises=None, impl: str = "chain"):
    """Greedy (no exploration noise) per-slot allocation: the amended
    ``(b, xi)`` of the allocator's ``greedy``.  ``generator`` drives the
    diffusion actor's reverse chain (or SCHRS' GA); ``x_L``/``noises``
    inject the chain's draws instead; ``impl`` picks its kernels
    (``reverse_sample``)."""
    if profiling.ON:
        with profiling.span("t2drl.greedy_slot_action"):
            return _greedy_slot_action(policy, cfg, env, models, generator,
                                       mask, x_L, noises, impl)
    return _greedy_slot_action(policy, cfg, env, models, generator, mask,
                               x_L, noises, impl)


def _greedy_slot_action(policy, cfg, env, models, generator, mask, x_L,
                        noises, impl):
    alloc, _ = _agents(cfg)
    s = observe(env, cfg.env, models, mask) if alloc.learns else None
    return alloc.greedy(policy, SlotObs(s, env, models, mask), generator,
                        x_L=x_L, noises=noises, impl=impl)


def greedy_frame_cache(policy, cfg: T2DRLCfg, models: ModelParams,
                       gamma_idx, generator=None):
    """Greedy (eps = 0) per-frame caching vector rho, from the cacher's
    ``greedy`` (a classical cacher serves the exported resident set)."""
    _, cacher = _agents(cfg)
    obs = FrameObs(gamma_idx, models)
    if profiling.ON:
        with profiling.span("t2drl.greedy_frame_cache"):
            return cacher.greedy(policy, obs, generator)
    return cacher.greedy(policy, obs, generator)


def greedy_episode(policy, cfg: T2DRLCfg, models: ModelParams,
                   generator: torch.Generator, mask=None,
                   mods=None) -> Dict[str, torch.Tensor]:
    """One greedy episode of Algorithm 1 from an exported policy: T frames
    of K slots, each agent acting through its ``greedy`` (no exploration,
    no replay, no updates); ``mask`` an optional (U,) active-user mask,
    ``mods`` an optional unbatched scenario schedule.  Returns the eight
    episode stats of ``_episode_core`` as 0-dim device tensors (no host
    read inside the episode)."""
    ec = cfg.env
    env = env_reset(generator, ec, schedule_slot_mod(mods, 0))
    cols = {k: [] for k in _SLOT_COLS}
    storage_viols = []
    for t in range(ec.T):
        env = env_advance_frame(env, ec, schedule_frame_P(mods, t),
                                schedule_slot_mod(mods, t * ec.K))
        rho = greedy_frame_cache(policy, cfg, models, env.gamma_idx,
                                 generator)
        env = env_set_cache(env, rho)
        for k in range(ec.K):
            b, xi = greedy_slot_action(policy, cfg, env, models, generator,
                                       mask)
            env, r, m = env_step_slot(
                env, ec, models, b, xi, mask,
                schedule_slot_mod(mods, t * ec.K + k + 1))
            _record_slot(cols, ec, r, m, mask)
        storage_viols.append(_storage_viol(rho, models, ec))
    return _episode_stats(cols, storage_viols)


def run_eval(policy, models: ModelParams, cfg: T2DRLCfg, *,
             episodes: int = 10, seed: int = 10_000, device=None,
             mask=None, mods=None) -> Dict[str, List[float]]:
    """Greedy evaluation: per-episode stats as lists of host floats (one
    host read per episode).  ``policy``, ``models``, the optional (U,)
    ``mask`` and the optional unbatched schedule ``mods`` must lie on
    ``resolve_device(device)``."""
    g = make_generator(seed, device)
    return _run_episodes(
        lambda step: greedy_episode(policy, cfg, models, g, mask, mods),
        [{}] * episodes, 0, None)


def run_eval_batch(ts: dict, cfg: T2DRLCfg, *, episodes: int = 10,
                   seed: int = 10_000, masks=None, mods=None,
                   device=None) -> Dict[str, list]:
    """Greedy evaluation of a batched train state's B cells in lockstep,
    as the reference's ``run_eval``: each episode is the batched episode
    (``_episode_batch``) at eps = sigma = 0 with no replay write and no
    update, so ``ts`` is left as it is (a classical cacher's state
    advances within each episode from the trained one, as in the
    reference); cell b draws from ``cell_generators(seed, B)[b]``.
    ``masks``: optional (B, U); ``mods``: a schedule, broadcast to the B
    cells if unbatched.  Returns per key a list of episodes of lists of B
    host floats."""
    B = ts["models"].a1.shape[0]
    gens = cell_generators(seed, B, device)
    mods = _broadcast_mods(mods, B)
    return _run_episodes(
        lambda step: _episode_batch(ts, cfg, gens, step, train=False,
                                    masks=masks, mods=mods)[1],
        [{"eps": 0.0, "sigma": 0.0}] * episodes, 0, None)


def eval_t2drl(policy, models: ModelParams, cfg: T2DRLCfg, *,
               episodes: int = 10, seed: int = 10_000, device=None,
               user_counts: Optional[Sequence[int]] = None,
               mods: Optional[ScenarioSchedule] = None, writer=None
               ) -> Dict[str, float]:
    """Greedy evaluation (no exploration, no updates) of one cell from an
    exported policy (``export_policy``) and its model zoo: the eight stats
    of the JAX ``eval_t2drl``, as means over episodes.  ``user_counts``
    (one entry) masks the cell to its first users; ``mods`` an unbatched
    scenario schedule (evaluating under another schedule than training
    measures out-of-scenario generalisation); ``writer`` receives an
    ``eval`` record of the means (after the run's manifest)."""
    mask = None
    if user_counts is not None:
        if len(user_counts) != 1:
            raise ValueError("eval_t2drl evaluates one cell: user_counts "
                             "needs one entry")
        mask = make_user_masks(cfg.env, user_counts)[0].to(models.c.device)
    if mods is not None and mods.h_scale.dim() == 2:
        mods = cell_of(_broadcast_mods(mods, 1), 0)
    hist = run_eval(policy, models, cfg, episodes=episodes, seed=seed,
                    device=device, mask=mask, mods=mods)
    out = {k: sum(v) / len(v) for k, v in hist.items()}
    if writer is not None:
        writer.ensure_manifest(cfg, extra={"episodes": int(episodes)},
                               device=models.c.device)
        writer.write("eval", metrics=out, episodes=int(episodes),
                     seed=int(seed))
    return out
