from .schedule import DiffusionSchedule, make_schedule  # noqa: F401
from .denoiser import (TIME_DIM, Denoiser, denoiser_apply,  # noqa: F401
                       denoiser_init, time_embedding)
from .sampler import reverse_sample, reverse_sample_actions  # noqa: F401
