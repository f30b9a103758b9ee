from .train_step import (TrainState, make_eval_step, make_train_state,
                         make_train_step)
from .trainer import StragglerWatchdog, Trainer

__all__ = ["StragglerWatchdog", "TrainState", "Trainer", "make_eval_step",
           "make_train_state", "make_train_step"]
