"""The paper's contribution, ported: environment, D3PG and DDQN learners,
baselines, replay buffers and the single-cell two-timescale loop
(``t2drl``), with the names ``repro.core`` exports for what is ported.

The names are resolved at first use (PEP 562), so importing
``repro_torch.core.networks`` from ``repro_torch.diffusion`` does not pull
in ``core.d3pg`` and no import cycle arises.
"""
import importlib

_EXPORTS = {
    "env": ("EnvCfg", "EnvState", "ModelParams", "env_reset",
            "env_new_frame", "env_step_slot", "make_models",
            "make_user_masks", "masked_mean", "observe", "slot_metrics",
            "slot_reward"),
    "quality": ("tv_quality", "gen_delay"),
    "ddqn": ("DDQNCfg", "amend_caching", "ddqn_act", "ddqn_init",
             "ddqn_update"),
    "d3pg": ("D3PGCfg", "actor_act", "amend_actions", "critic_q",
             "d3pg_init", "d3pg_update", "make_actor_schedule"),
    "buffers": ("buffer_add", "buffer_add_many", "buffer_init",
                "buffer_sample"),
    "baselines": ("GACfg", "random_cache", "rcars_allocate",
                  "static_popular_cache"),
    "t2drl": ("T2DRLCfg", "episode_epsilon", "episode_lr_scale",
              "episode_sigma", "eval_t2drl", "export_policy",
              "greedy_frame_cache", "greedy_slot_action", "run_eval",
              "t2drl_init", "train_t2drl"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name in _WHERE:
        return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
