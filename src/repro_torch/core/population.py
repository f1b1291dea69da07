"""Population-based hyperparameter sweeps over the fused independent core,
port of ``repro.core.population``.

A population is B independent learners trained together (the fused core,
DESIGN.md §13), each member with its own hyperparameters — epsilon/sigma
exploration schedules, actor/critic/DDQN learning rates and the
beyond-paper ``shape_hit`` reward shaping — delivered as per-member (E, B)
schedules through ``run_training(pop=...)``.

``updates_per_slot`` changes the program (the updates a slot runs), so it
cannot vary inside one run: ``train_population`` groups members by it and
trains one group at a time.

The sweep: train every member, evaluate each greedily
(``run_eval_batch``: eps = sigma = 0, no updates), rank by mean
evaluation utility.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import torch

from .t2drl import (T2DRLCfg, cell_generators, episode_epsilon,
                    episode_lr_scale, episode_sigma, run_eval_batch,
                    run_training, t2drl_init_batch)


@dataclasses.dataclass(frozen=True)
class PopMember:
    """One population member: overrides of a base ``T2DRLCfg`` (``None``
    inherits the base's value).  Every field but ``updates_per_slot`` is a
    per-member schedule; ``updates_per_slot`` defines the member's group.
    ``name`` labels leaderboards (derived from the overrides when
    empty)."""
    eps_start: Optional[float] = None
    eps_end: Optional[float] = None
    eps_decay_episodes: Optional[int] = None
    eps_schedule: Optional[str] = None
    lr_actor: Optional[float] = None
    lr_critic: Optional[float] = None
    lr_ddqn: Optional[float] = None
    lr_schedule: Optional[str] = None
    lr_warmdown_episodes: Optional[int] = None
    shape_hit: float = 0.0
    updates_per_slot: Optional[int] = None
    name: str = ""

    def label(self) -> str:
        if self.name:
            return self.name
        parts = [f"{f.name}={getattr(self, f.name)}"
                 for f in dataclasses.fields(self)
                 if f.name not in ("name", "shape_hit")
                 and getattr(self, f.name) is not None]
        if self.shape_hit:
            parts.append(f"shape_hit={self.shape_hit}")
        return ",".join(parts) if parts else "base"

    def member_cfg(self, cfg: T2DRLCfg) -> T2DRLCfg:
        """The base config with this member's overrides: what its
        schedules are computed from."""
        overrides = {f.name: getattr(self, f.name)
                     for f in dataclasses.fields(self)
                     if f.name not in ("name", "shape_hit")
                     and getattr(self, f.name) is not None}
        return dataclasses.replace(cfg, **overrides)


def population_schedules(cfg: T2DRLCfg, members: Sequence[PopMember],
                         episodes: int) -> dict:
    """Per-member schedules as a ``pop`` dict of (E, B) f32 tensors, each
    column computed by the driver's own schedule functions, so a
    one-member population reproduces the plain schedules."""
    e = torch.arange(episodes, dtype=torch.float32)
    cols = {k: [] for k in ("eps", "sigma", "lr_actor", "lr_critic",
                            "lr_ddqn", "shape_hit")}
    for m in members:
        mc = m.member_cfg(cfg)
        scale = episode_lr_scale(mc, e)
        cols["eps"].append(episode_epsilon(mc, e))
        cols["sigma"].append(episode_sigma(mc, e))
        cols["lr_actor"].append(mc.lr_actor * scale)
        cols["lr_critic"].append(mc.lr_critic * scale)
        cols["lr_ddqn"].append(torch.full((episodes,), mc.lr_ddqn))
        cols["shape_hit"].append(torch.full((episodes,), m.shape_hit))
    return {k: torch.stack(v, dim=1).to(torch.float32)
            for k, v in cols.items()}


def _group_members(cfg: T2DRLCfg, members: Sequence[PopMember]):
    """Members grouped by ``updates_per_slot``: yields ``(group_cfg,
    [(index, member), ...])``, input order kept within a group."""
    def key(m: PopMember):
        return (m.updates_per_slot if m.updates_per_slot is not None
                else cfg.updates_per_slot)

    order = sorted(enumerate(members), key=lambda im: key(im[1]))
    for ups, grp in itertools.groupby(order, key=lambda im: key(im[1])):
        yield dataclasses.replace(cfg, updates_per_slot=ups), list(grp)


def train_population(cfg: T2DRLCfg, members: Sequence[PopMember], *,
                     episodes: int, eval_episodes: int = 4, seed: int = 0,
                     share_models: bool = True, log=None, device=None):
    """Train and evaluate a population, one fused run per group.

    Every member trains ``episodes`` episodes as a fused independent
    learner (``cfg.policy`` and ``independent_impl`` are forced to
    "independent"/"fused"), then is evaluated greedily for
    ``eval_episodes`` episodes.  ``share_models=True`` gives every member
    one model zoo, so the sweep compares hyperparameters, not env draws.
    The cells' generators come from ``cell_generators(seed, B)`` for
    training and ``cell_generators(seed + 10_000, B)`` for evaluation.

    Returns ``(results, groups)``: per member (input order) its
    ``label``, ``member``, training ``history`` (per key, a list over
    episodes) and mean ``eval`` stats; and per group its
    ``updates_per_slot`` and member labels."""
    cfg = dataclasses.replace(cfg, policy="independent",
                              independent_impl="fused")
    results = [None] * len(members)
    groups = []
    for group_cfg, grp in _group_members(cfg, members):
        ms = [m for _, m in grp]
        B = len(ms)
        gens = cell_generators(seed, B, device)
        ts = t2drl_init_batch(gens, group_cfg, share_models=share_models)
        if log:
            log(f"group updates_per_slot={group_cfg.updates_per_slot}: "
                f"{B} members x {episodes} episodes")
        ts, hist = run_training(ts, group_cfg, gens, episodes,
                                pop=population_schedules(group_cfg, ms,
                                                         episodes))
        ev = run_eval_batch(ts, group_cfg, episodes=eval_episodes,
                            seed=seed + 10_000, device=device)
        for j, (i, m) in enumerate(grp):
            results[i] = {
                "label": m.label(), "member": m,
                "history": {k: [ep[j] for ep in v] for k, v in hist.items()},
                "eval": {k: sum(ep[j] for ep in v) / len(v)
                         for k, v in ev.items()}}
        groups.append({"updates_per_slot": group_cfg.updates_per_slot,
                       "members": [m.label() for m in ms]})
    return results, groups


def rank_population(results, *, by: str = "utility", descending=None):
    """Member results best-first by a mean-eval stat; ``delay``,
    ``deadline_viol`` and ``storage_viol`` sort ascending unless
    overridden."""
    if descending is None:
        descending = by not in ("delay", "deadline_viol", "storage_viol")
    return sorted(results, key=lambda r: r["eval"][by], reverse=descending)


def default_grid(*, updates_per_slot: Sequence[int] = (1,)) -> list:
    """The stock 16-member grid: eps schedule x actor/critic LR x DDQN LR x
    reward shaping, optionally crossed with ``updates_per_slot`` groups."""
    grid = []
    for ups in updates_per_slot:
        for eps_start, eps_sched in ((1.0, "linear"), (0.6, "cosine")):
            for lr_a, lr_c in ((1e-4, 1e-3), (3e-4, 3e-3)):
                for lr_q in (1e-3, 3e-3):
                    for shape in (0.0, 0.5):
                        grid.append(PopMember(
                            eps_start=eps_start, eps_schedule=eps_sched,
                            lr_actor=lr_a, lr_critic=lr_c, lr_ddqn=lr_q,
                            shape_hit=shape,
                            updates_per_slot=(ups if len(updates_per_slot)
                                              > 1 else None),
                            name=(f"eps{eps_start}-{eps_sched}_a{lr_a}"
                                  f"_c{lr_c}_q{lr_q}_s{shape}"
                                  + (f"_u{ups}" if len(updates_per_slot) > 1
                                     else ""))))
    return grid
