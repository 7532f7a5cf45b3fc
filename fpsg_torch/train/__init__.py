"""Episodic training (counterpart of ``fpsg_tpu.train``)."""

from fpsg_torch.train.optim import make_lr_schedule, make_optimizer
from fpsg_torch.train.state import TrainState
from fpsg_torch.train.step import init_model, init_state, make_train_step

__all__ = ["TrainState", "init_model", "init_state", "make_lr_schedule",
           "make_optimizer", "make_train_step"]
