"""Optimizer and learning-rate schedule (counterpart of
``fpsg_tpu/train/optim.py``; reference ``src/trainNetwork.py:118-130``).

Adam with betas (0.9, 0.999), eps 1e-8 and f32 moments — the update of
``optax.adam``: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
``p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``, which
``torch.optim.Adam`` computes with other roundings. A parameter whose
gradient is ``None`` (a bias folded into a BatchNorm) is left unchanged, as
optax leaves one whose gradient is 0 from the first step.

The learning rate follows torch's StepLR, halved every ``lr_decay_epochs``
epochs and counted in steps; the train step sets it before each update.

Not ported yet: ``--SGD``, ``bf16_moments`` (``scale_by_adam_compact``) and
the finetune ``frozen_mask``.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def make_lr_schedule(lr: float, lr_decay_epochs: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """``lr * 0.5 ** (epoch // lr_decay_epochs)`` at a step count."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return lr * (0.5 ** (epoch // max(lr_decay_epochs, 1)))

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   lr: float = 1e-3) -> torch.optim.Adam:
    """Adam over ``params`` at the schedule's first rate ``lr``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
