"""Scenario registry: named, composable workload transforms (DESIGN.md
§9), port of ``repro.scenarios.registry``.

A scenario is a recipe for an edge workload: a static transform of the
``EnvCfg``, a :class:`ModSpec` of time-varying modulation that
``make_schedule`` turns into a ``ScenarioSchedule`` (diurnal popularity
rotation, flash-crowd bursts, degraded channels), and optional per-cell
user counts.  Scenarios compose (``compose``).  Schedules are built in
numpy, as the reference builds them, then become tensors on the caller's
device::

    from repro_torch.scenarios import build_scenario
    b = build_scenario("flash-crowd", cfg.env, num_envs=4)
    cfg = dataclasses.replace(cfg, env=b.env)
    ts, hist = train_t2drl(cfg, num_envs=4, mods=b.mods,
                           user_counts=b.user_counts)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.env import EnvCfg, ScenarioSchedule
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModSpec:
    """Modulation parameters, the reference's fields; an all-default spec
    builds no schedule (``None``: the unmodulated env), which is what makes
    ``paper-default`` the paper's env exactly.  See
    ``repro.scenarios.registry.ModSpec`` for each field."""
    diurnal_period: int = 0
    diurnal_strength: float = 0.0
    burst_period: int = 0
    burst_width: int = 2
    burst_prob: float = 0.85
    burst_model: int = 0
    burst_din_scale: float = 1.0
    h_scale: float = 1.0
    degraded_frac: float = 0.0
    degraded_h_scale: float = 1.0

    def is_identity(self) -> bool:
        return self == ModSpec()


def _rotated_P(base: np.ndarray, spec: ModSpec, T: int) -> np.ndarray:
    """(T, J, J) frame-indexed popularity transitions: a convex mixture of
    the base chain and a 'push' chain whose dominant state rotates through
    the J states once per diurnal period."""
    J = base.shape[0]
    out = np.tile(base, (T, 1, 1))
    if not spec.diurnal_period or spec.diurnal_strength <= 0.0:
        return out
    for t in range(T):
        phase = (t % spec.diurnal_period) / spec.diurnal_period
        s = int(phase * J) % J
        push = np.full((J, J), 0.3 / J)
        push[:, s] += 0.7
        w = spec.diurnal_strength * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * phase))
        out[t] = (1.0 - w) * base + w * push
    return out


def _schedule_arrays(spec: ModSpec, cfg: EnvCfg,
                    num_envs: int = 1) -> Optional[dict]:
    """The schedule's leaves as numpy arrays, exactly as the reference's
    ``make_schedule`` computes them (f32 leaves, an int32 model id), or
    None for the identity spec.  Cell-heterogeneous specs
    (``degraded_frac > 0``) give per-cell leaves, (B,) leading."""
    if spec.is_identity():
        return None
    T, K, J = cfg.T, cfg.K, len(cfg.gammas)
    S = T * K
    P = _rotated_P(np.asarray(cfg.P_gamma, np.float32), spec, T)
    h = np.full((S,), spec.h_scale, np.float32)
    din = np.ones((S,), np.float32)
    bp = np.zeros((S,), np.float32)
    if spec.burst_period:
        g = np.arange(S)
        in_burst = (g % spec.burst_period) < spec.burst_width
        bp[in_burst] = spec.burst_prob
        din[in_burst] *= spec.burst_din_scale
    out = {"P_gamma": P, "h_scale": h, "din_scale": din, "burst_prob": bp,
           "burst_model": np.int32(min(spec.burst_model, cfg.M - 1))}
    if spec.degraded_frac > 0.0:
        n_bad = math.ceil(spec.degraded_frac * num_envs)
        cell_scale = np.ones((num_envs,), np.float32)
        cell_scale[:n_bad] = spec.degraded_h_scale
        B = num_envs
        out = {"P_gamma": np.broadcast_to(P, (B, T, J, J)),
               "h_scale": cell_scale[:, None] * h,
               "din_scale": np.broadcast_to(din, (B, S)),
               "burst_prob": np.broadcast_to(bp, (B, S)),
               "burst_model": np.broadcast_to(out["burst_model"], (B,))}
    return out


def make_schedule(spec: ModSpec, cfg: EnvCfg, num_envs: int = 1,
                  device=None) -> Optional[ScenarioSchedule]:
    """A ModSpec as a ``ScenarioSchedule`` on ``resolve_device(device)``:
    ``_schedule_arrays``' leaves as f32 tensors (P_gamma from the f32 base,
    mixed in f64 and stored in f32, as the reference does) and an int64
    model id; ``None`` for the identity spec."""
    arrays = _schedule_arrays(spec, cfg, num_envs)
    if arrays is None:
        return None
    dev = resolve_device(device)
    return ScenarioSchedule(**{
        k: torch.tensor(np.array(v, dtype=np.int64 if k == "burst_model"
                                 else np.float32), device=dev)
        for k, v in arrays.items()})


def _id_env(cfg: EnvCfg) -> EnvCfg:
    return cfg


def _id_mods(spec: ModSpec) -> ModSpec:
    return spec


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, composable workload transform: ``env`` (EnvCfg -> EnvCfg),
    ``mods`` (ModSpec -> ModSpec) and optional ``user_counts``
    ((EnvCfg, num_envs) -> per-cell active users)."""
    name: str
    summary: str
    env: Callable[[EnvCfg], EnvCfg] = _id_env
    mods: Callable[[ModSpec], ModSpec] = _id_mods
    user_counts: Optional[Callable[[EnvCfg, int], Tuple[int, ...]]] = None


@dataclasses.dataclass(frozen=True)
class ScenarioBuild:
    """A materialized scenario: the transformed ``env`` (for
    ``T2DRLCfg.env``), the schedule ``mods`` (``None``: unmodulated) and
    per-cell ``user_counts`` (or None)."""
    env: EnvCfg
    mods: Optional[ScenarioSchedule]
    user_counts: Optional[Tuple[int, ...]]


_REGISTRY: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    """Add a scenario to the registry (the name must be unused)."""
    if scenario.name in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    """A registered scenario by name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{', '.join(sorted(_REGISTRY))}") from None


def list_scenarios() -> Dict[str, str]:
    """Registered scenario names -> one-line summaries (sorted)."""
    return {n: _REGISTRY[n].summary for n in sorted(_REGISTRY)}


def compose(name: str, *parts, summary: str = "") -> Scenario:
    """Stack scenarios left to right into a new (unregistered) Scenario:
    env and ModSpec transforms apply in order; the last part that gives
    ``user_counts`` wins."""
    parts = tuple(get_scenario(p) if isinstance(p, str) else p
                  for p in parts)

    def env(cfg: EnvCfg) -> EnvCfg:
        for p in parts:
            cfg = p.env(cfg)
        return cfg

    def mods(spec: ModSpec) -> ModSpec:
        for p in parts:
            spec = p.mods(spec)
        return spec

    counts = None
    for p in parts:
        if p.user_counts is not None:
            counts = p.user_counts
    return Scenario(name=name, summary=summary or " + ".join(
        p.name for p in parts), env=env, mods=mods, user_counts=counts)


def build_scenario(scenario, base_env: EnvCfg, num_envs: int = 1,
                   device=None) -> ScenarioBuild:
    """Materialize a scenario (name or Scenario) against ``base_env`` for
    ``num_envs`` cells, its schedule on ``resolve_device(device)``."""
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    env = scenario.env(base_env)
    mods = make_schedule(scenario.mods(ModSpec()), env, num_envs, device)
    counts = (None if scenario.user_counts is None
              else tuple(scenario.user_counts(env, num_envs)))
    return ScenarioBuild(env=env, mods=mods, user_counts=counts)
