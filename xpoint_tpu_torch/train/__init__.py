"""The training step and optimiser."""
from .train_step import (TrainState, make_eval_step,  # noqa: F401
                         make_optimizer, make_train_step)
