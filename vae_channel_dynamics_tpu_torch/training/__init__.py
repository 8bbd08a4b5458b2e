from .state import TrainState
from .step import build_optimizer, make_eval_step, make_lr_schedule, make_train_step

__all__ = [
    "TrainState",
    "build_optimizer",
    "make_eval_step",
    "make_lr_schedule",
    "make_train_step",
]
