"""Activation registry (counterpart of ``fpsg_tpu/nn/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "logsigmoid": F.logsigmoid,
    "tanh": torch.tanh,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
}


def get_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise NotImplementedError(f"Unsupported activation: {name}")
