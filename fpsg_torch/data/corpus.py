"""Image normalization shared by serving and (later) training
(counterpart of ``fpsg_tpu/data/corpus.py:normalize_images``)."""

from __future__ import annotations

import torch


def normalize_images(img_u8: torch.Tensor) -> torch.Tensor:
    """ToTensor + Normalize((.5,)*3, (.5,)*3): uint8 -> [-1, 1] f32."""
    return img_u8.float() * (2.0 / 255.0) - 1.0
