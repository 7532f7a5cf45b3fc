"""Parameter initializers matching PyTorch layer defaults.

torch ``Conv1d``/``Conv2d``/``Linear`` weights default to
``kaiming_uniform_(a=sqrt(5))`` and biases to ``U(-1/sqrt(fan_in),
1/sqrt(fan_in))``; both reduce to ``U(+-1/sqrt(fan_in))`` — the same
distribution as ``fpsg_tpu/nn/_init.py`` and ``fpsg_tpu/nn/vgg.py:_conv_init``.
Draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def uniform_fan_in(shape: Sequence[int], fan_in: int,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``U(-1/sqrt(fan_in), +1/sqrt(fan_in))`` f32 tensor on the CPU."""
    bound = 1.0 / float(fan_in) ** 0.5
    t = torch.empty(tuple(shape), dtype=torch.float32)
    return t.uniform_(-bound, bound, generator=generator)
