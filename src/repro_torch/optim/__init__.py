"""Optimizers (port of ``repro.optim``): hand-written Adam/AdamW, its
stacked (B-learner) form and the learning-rate schedules."""
from .adam import (adam_init, adam_init_stacked, adam_learner,  # noqa: F401
                   adam_update, adam_update_stacked, clip_by_global_norm,
                   global_norm, global_norm_stacked, learner_values,
                   stack_adam)
from .schedules import constant, cosine_decay, linear_warmup_cosine  # noqa: F401
