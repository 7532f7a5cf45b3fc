"""Image branch: VGG16-bn encoder, eval mode
(counterpart of ``fpsg_tpu/nn/vgg.py``).

torchvision VGG16-bn ``.features`` + a global average pool: a 224x224x3
NHWC image batch -> (B, 512) f32. Module names carry the torchvision
``features_<i>`` index, as in the JAX package.

- The 3x3 SAME convs go to ``F.conv2d`` (cuDNN on the card; the JAX
  package leaves them to XLA, ``vgg.py:385-388``). Activations stay NHWC in
  memory: the conv sees them as a channels_last NCHW view.
- Each conv's bias folds into the following BatchNorm (``shift=``), which
  applies the collapsed affine with relu fused.
- Every ``"M"`` is the 2x2 max-pool kernel (``fpsg_torch/ops/pool.py``).
- The final mean over H, W is taken in f32 (``vgg.py:689``).

Not ported: the space-to-depth execution of block 1 (``vgg.py:41-89,
560-613``) — a TPU lane-filling rewrite of the same conv; the weights keep
their logical ``(64, 3, 3, 3)`` shape here. Also not yet ported:
``fused_conv``, ``winograd``, ``stage_slice`` and ``TinyImageEncoder``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from fpsg_torch.nn._init import uniform_fan_in
from fpsg_torch.nn.normalization import BatchNorm
from fpsg_torch.ops.pool import maxpool2x2

# torchvision cfg 'D' (vgg16): conv widths with 'M' maxpools.
VGG16_CFG: Sequence[Union[int, str]] = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
    512, 512, 512, "M", 512, 512, 512, "M",
)


class ConvFold(nn.Module):
    """3x3 SAME conv, NHWC in and out, whose bias is returned for the
    following BatchNorm to fold (not added to the activation)."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = 9 * in_ch
        self.dtype = dtype
        self.weight = nn.Parameter(
            uniform_fan_in((out_ch, in_ch, 3, 3), fan_in, generator))
        self.bias = nn.Parameter(uniform_fan_in((out_ch,), fan_in, generator))

    def forward(self, x: torch.Tensor):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                     padding=1)
        return y.permute(0, 2, 3, 1).contiguous(), self.bias


class VGG16BN(nn.Module):
    """VGG16-bn feature extractor: (B, H, W, 3) -> (B, 512) f32."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self._plan = []           # ("conv", conv_name, bn_name) | ("pool",)
        idx, in_ch = 0, 3
        for v in VGG16_CFG:
            if v == "M":
                self._plan.append(("pool",))
                idx += 1
                continue
            conv, bn = f"features_{idx}", f"features_{idx + 1}"
            self.add_module(conv, ConvFold(in_ch, v, dtype, generator))
            self.add_module(bn, BatchNorm((v,), activation="relu",
                                          dtype=dtype))
            self._plan.append(("conv", conv, bn))
            in_ch = v
            idx += 3              # conv, bn, relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        for step in self._plan:
            if step[0] == "pool":
                x = maxpool2x2(x)
                continue
            y, b = getattr(self, step[1])(x)
            x = getattr(self, step[2])(y, shift=b)
        return torch.mean(x.float(), dim=(1, 2))


class ImageEncoder(nn.Module):
    """Backbone selector behind the fixed 512-d interface."""

    def __init__(self, backbone: str = "vgg_16",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if backbone != "vgg_16":
            raise NotImplementedError(
                f"image encoder backbone {backbone!r} is not ported")
        self.encoder = VGG16BN(dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)
