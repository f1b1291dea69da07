"""Config-driven scenario registry (DESIGN.md §9), port of
``repro.scenarios``: ``build_scenario(name, env_cfg, num_envs, device)``
gives the ``ScenarioBuild(env, mods, user_counts)`` that ``train_t2drl`` /
``eval_t2drl`` take; ``list_scenarios``/``get_scenario`` inspect the
registry, ``register``/``compose`` define new scenarios, ``ModSpec`` /
``make_schedule`` build schedules from scratch."""
from .registry import (ModSpec, Scenario, ScenarioBuild,  # noqa: F401
                       build_scenario, compose, get_scenario,
                       list_scenarios, make_schedule, register)
from . import builtin  # noqa: F401  (registers the built-in scenarios)
