"""Kernel wrappers' shared plumbing: device dispatch and launch counters.

Every wrapper in the port follows one rule: a tensor on the CPU runs the
plain PyTorch version, a tensor on a CUDA device launches the hand-written
kernel (or raises). Nothing falls back from the kernel to the plain path.

Each wrapper adds one to its counter exactly where it launches its kernel,
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

import torch

_launches: Dict[str, int] = {}


def register_kernel(name: str) -> None:
    """Declare a kernel's launch counter (at 0)."""
    _launches.setdefault(name, 0)


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    """A copy of every kernel's launch count."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def on_card(*tensors: torch.Tensor) -> bool:
    """True if the tensors lie on a CUDA device, False if on the CPU.

    Raises if they lie on different devices or on any other device type.
    """
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {dev}")
