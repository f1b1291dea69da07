"""Built-in scenarios (DESIGN.md §9), port of ``repro.scenarios.builtin``:
the same names, transforms and schedules.  ``paper-default`` is the
paper's env exactly (no schedule)."""
from __future__ import annotations

import dataclasses
import math

from .registry import ModSpec, Scenario, compose, register

register(Scenario(
    name="paper-default",
    summary="the paper's stationary Markov workload, bit-for-bit "
            "(identity transform, no modulation schedule)"))


register(Scenario(
    name="diurnal",
    summary="diurnal popularity rotation: the dominant Zipf-skewness state "
            "sweeps through the J states once per half-episode",
    mods=lambda s: dataclasses.replace(
        s, diurnal_period=5, diurnal_strength=0.8)))


register(Scenario(
    name="flash-crowd",
    summary="periodic flash crowds: every 10 slots, 3 slots where 85% of "
            "users pile onto one hot model with 1.5x input sizes",
    mods=lambda s: dataclasses.replace(
        s, burst_period=10, burst_width=3, burst_prob=0.85, burst_model=0,
        burst_din_scale=1.5)))


def _cycling_counts(cfg, num_envs):
    """Per-cell populations cycling U, 3U/4, U/2, U/4 (min 1 user)."""
    fracs = (1.0, 0.75, 0.5, 0.25)
    return tuple(max(1, math.ceil(cfg.U * fracs[b % len(fracs)]))
                 for b in range(num_envs))


register(Scenario(
    name="hetero-cells",
    summary="heterogeneous cells: per-cell user populations cycle "
            "U, 3U/4, U/2, U/4 over independent per-cell model zoos",
    user_counts=_cycling_counts))


register(Scenario(
    name="degraded-channel",
    summary="half the cells run with 10 dB worse channel gains "
            "(edge-of-coverage / interference-limited deployments)",
    mods=lambda s: dataclasses.replace(
        s, degraded_frac=0.5, degraded_h_scale=10.0 ** (-1.0))))


register(compose(
    "rush-hour", "diurnal", "flash-crowd", "degraded-channel", "hetero-cells",
    summary="diurnal + flash-crowd + degraded-channel + hetero-cells "
            "stacked: the everything-at-once stress workload"))
