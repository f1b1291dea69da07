from .schedule import DiffusionSchedule, make_schedule  # noqa: F401
from .denoiser import (TIME_DIM, Denoiser, StackedDenoiser,  # noqa: F401
                       denoiser_apply, denoiser_apply_stacked,
                       denoiser_init, stack_denoisers, time_embedding)
from .sampler import (reverse_sample, reverse_sample_actions,  # noqa: F401
                      reverse_sample_actions_stacked,
                      reverse_sample_actions_stacked_stats,
                      reverse_sample_actions_stats, reverse_sample_stacked)
