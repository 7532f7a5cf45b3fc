"""Optimizer and learning-rate schedule (counterpart of
``fpsg_tpu/train/optim.py``; reference ``src/trainNetwork.py:118-130``).

Adam with betas (0.9, 0.999), eps 1e-8 and f32 moments — the update of
``optax.adam``: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
``p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``, which
``torch.optim.Adam`` computes with other roundings. A parameter whose
gradient is ``None`` (a bias folded into a BatchNorm) is left unchanged, as
optax leaves one whose gradient is 0 from the first step.

``bf16_moments`` (``bench.py --bf16-moments``) takes :class:`CompactAdam`,
the port of ``scale_by_adam_compact`` followed by the scheduled rate
(``optim.py:15-69``, ``:107-111``): the moments are stored in bf16 and
upcast, the recurrences and the update run in f32, and each stored moment
rounds once a step.

The learning rate follows torch's StepLR, halved every ``lr_decay_epochs``
epochs and counted in steps; the train step sets it before each update.

Not ported yet: ``--SGD`` and the finetune ``frozen_mask``.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


def make_lr_schedule(lr: float, lr_decay_epochs: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """``lr * 0.5 ** (epoch // lr_decay_epochs)`` at a step count."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return lr * (0.5 ** (epoch // max(lr_decay_epochs, 1)))

    return schedule


class CompactAdam(torch.optim.Optimizer):
    """Adam with its moments stored in ``moment_dtype`` and every step
    computed in f32 (``scale_by_adam_compact`` + ``scale_by_learning_rate``).

    Per step, with the update count ``t`` (one per step, as optax's
    ``count``) and ``g`` the f32 gradient:

        mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2     (f32)
        p += -lr * ((mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps))

    and ``mu``, ``nu`` are stored rounded to ``moment_dtype``. The step is
    a fixed number of ``torch._foreach_*`` calls whatever the number of
    parameters. A parameter whose gradient is ``None`` is left unchanged
    with its moments.
    """

    def __init__(self, params, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 moment_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, count=0))
        self.moment_dtype = moment_dtype

    def _moments(self, params):
        mus, nus = [], []
        for p in params:
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p, dtype=self.moment_dtype)
                st["exp_avg_sq"] = torch.zeros_like(p,
                                                    dtype=self.moment_dtype)
            mus.append(st["exp_avg"])
            nus.append(st["exp_avg_sq"])
        return mus, nus

    @staticmethod
    def _upcast(grads, moments) -> list:
        """f32 copies of the stored moments (grads' shapes and dtype)."""
        out = torch._foreach_mul(grads, 0.0)
        torch._foreach_copy_(out, moments)
        return out

    def updates(self, group) -> list:
        """Advance ``group``'s count and moments by one step; return the
        f32 updates ``-lr * ...`` of its parameters that have gradients."""
        params = [p for p in group["params"] if p.grad is not None]
        group["count"] += 1
        if not params:
            return []
        grads = [p.grad for p in params]
        b1, b2 = group["betas"]
        mus, nus = self._moments(params)
        # b1 mu + (1 - b1) g and b2 nu + (1 - b2) g^2 on the f32 upcasts,
        # each product rounded, then the sum; one dtype per foreach call
        m, v = self._upcast(grads, mus), self._upcast(grads, nus)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(v, b2)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - b2)
        torch._foreach_add_(v, g2)
        torch._foreach_copy_(mus, m)
        torch._foreach_copy_(nus, v)
        # the bias corrections in f32, as optax computes them
        t = np.float32(group["count"])
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -group["lr"])
        return upd

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            upd = self.updates(group)
            if params:
                torch._foreach_add_(params, upd)
        return loss


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   lr: float = 1e-3,
                   bf16_moments: bool = False) -> torch.optim.Optimizer:
    """Adam over ``params`` at the schedule's first rate ``lr``: f32 moments
    (``torch.optim.Adam``), or bf16-stored ones (:class:`CompactAdam`)."""
    if bf16_moments:
        return CompactAdam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
