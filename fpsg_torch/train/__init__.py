"""Episodic training and evaluation (counterpart of ``fpsg_tpu.train``)."""

from fpsg_torch.train.eval import (
    episodic_eval, evaluate, make_eval_step, run_sequential,
)
from fpsg_torch.train.optim import make_lr_schedule, make_optimizer
from fpsg_torch.train.state import TrainState
from fpsg_torch.train.step import init_model, init_state, make_train_step

__all__ = ["TrainState", "episodic_eval", "evaluate", "init_model",
           "init_state", "make_eval_step", "make_lr_schedule",
           "make_optimizer", "make_train_step", "run_sequential"]
