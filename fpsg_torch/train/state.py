"""Training state (counterpart of ``fpsg_tpu/train/state.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm running statistics), the
    optimizer (its moments) and the global step, which drives the
    learning-rate schedule. The train step updates all three in place."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
