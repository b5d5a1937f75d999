"""Optimizers (in place) and LR schedules: ``repro.optim``'s port."""
from .optimizers import (Optimizer, adamw_init, adamw_update, adafactor_init,
                         adafactor_update, make_optimizer, global_norm,
                         clip_by_global_norm)
from .schedules import warmup_cosine, warmup_linear, constant

__all__ = ["Optimizer", "adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "make_optimizer", "global_norm",
           "clip_by_global_norm", "warmup_cosine", "warmup_linear",
           "constant"]
