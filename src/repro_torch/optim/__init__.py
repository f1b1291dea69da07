"""Optimizers (port of ``repro.optim``): hand-written Adam/AdamW and the
learning-rate schedules.  The stacked (B-learner) Adam raises until
ROADMAP A.6."""
from .adam import (adam_init, adam_init_stacked, adam_update,  # noqa: F401
                   adam_update_stacked, clip_by_global_norm, global_norm,
                   global_norm_stacked)
from .schedules import constant, cosine_decay, linear_warmup_cosine  # noqa: F401
