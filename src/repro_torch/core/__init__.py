"""The paper's contribution, ported: environment, D3PG and DDQN learners,
baselines, replay buffers, the classical cache policies, the
two-timescale loop (``t2drl``: one cell, the vector-env modes and cells
sharded over ranks) and population sweeps, with the names ``repro.core``
exports; the legacy ``*_batch`` learner helpers come from
``repro_torch.agents.compat``, as the reference's do.

The names are resolved at first use (PEP 562), so importing
``repro_torch.core.networks`` from ``repro_torch.diffusion`` does not pull
in ``core.d3pg`` and no import cycle arises.
"""
import importlib

_EXPORTS = {
    "env": ("EnvCfg", "EnvState", "ModelParams", "ScenarioSchedule",
            "SlotMod", "env_reset", "env_reset_batch", "env_new_frame",
            "env_step_slot", "make_models", "make_models_batch",
            "make_user_masks", "masked_mean", "observe", "schedule_frame_P",
            "schedule_slot_mod", "slot_metrics", "slot_reward"),
    "quality": ("tv_quality", "gen_delay"),
    "ddqn": ("DDQNCfg", "amend_caching", "ddqn_act", "ddqn_act_stacked",
             "ddqn_init", "ddqn_update", "ddqn_update_stacked"),
    "d3pg": ("D3PGCfg", "actor_act", "actor_act_stacked", "amend_actions",
             "critic_q", "critic_q_stacked", "d3pg_init", "d3pg_update",
             "d3pg_update_stacked", "make_actor_schedule"),
    "buffers": ("buffer_add", "buffer_add_batch", "buffer_add_many",
                "buffer_add_many_batch", "buffer_add_many_stacked",
                "buffer_init", "buffer_init_batch", "buffer_sample",
                "buffer_sample_batch", "buffer_sample_stacked"),
    "baselines": ("GACfg", "ga_allocate", "random_cache",
                  "random_cache_batch", "rcars_allocate",
                  "static_popular_cache", "static_popular_cache_batch"),
    "cache_policies": ("CACHE_POLICIES", "cache_access", "cache_rho",
                       "cache_state_init", "quantize_capacity",
                       "quantize_sizes"),
    "t2drl": ("T2DRLCfg", "cell_generators", "episode_epsilon",
              "episode_lr_scale", "episode_sigma", "eval_t2drl",
              "export_policy", "greedy_frame_cache", "greedy_slot_action",
              "run_episode", "run_eval", "run_eval_batch", "run_training",
              "run_training_sharded", "t2drl_init", "t2drl_init_batch",
              "train_t2drl"),
    "population": ("PopMember", "default_grid", "population_schedules",
                   "rank_population", "train_population"),
}
_WHERE = {name: f"{__name__}.{mod}" for mod, names in _EXPORTS.items()
          for name in names}
_WHERE.update({name: "repro_torch.agents.compat" for name in (
    "d3pg_init_batch", "d3pg_update_batch", "ddqn_init_batch",
    "ddqn_update_batch")})
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name in _WHERE:
        return getattr(importlib.import_module(_WHERE[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
