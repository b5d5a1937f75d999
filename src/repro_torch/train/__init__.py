"""The train step, on one device or over a (data, model) mesh
(``train/trainer.py``)."""
from .trainer import (TrainConfig, abstract_state, init_state,
                      make_schedule, make_train_step, state_from_params,
                      state_shardings)

__all__ = ["TrainConfig", "abstract_state", "init_state", "make_schedule",
           "make_train_step", "state_from_params", "state_shardings"]
