"""The single-device train step (``train/trainer.py``)."""
from .trainer import (TrainConfig, init_state, make_schedule,
                      make_train_step, state_from_params)

__all__ = ["TrainConfig", "init_state", "make_schedule", "make_train_step",
           "state_from_params"]
