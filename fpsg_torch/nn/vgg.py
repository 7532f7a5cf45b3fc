"""Image branch: VGG16-bn encoder (counterpart of ``fpsg_tpu/nn/vgg.py``).

torchvision VGG16-bn ``.features`` + a global average pool: a 224x224x3
NHWC image batch -> (B, 512) f32. Module names carry the torchvision
``features_<i>`` index, as in the JAX package.

- The 3x3 SAME convs go to ``F.conv2d`` (cuDNN on the card; the JAX
  package leaves them to XLA, ``vgg.py:385-388``). Activations stay NHWC in
  memory: the conv sees them as a channels_last NCHW view.
- Each conv's bias folds into the following BatchNorm (``shift=``), which
  applies the collapsed affine with relu fused; in training with batch
  statistics, two-pass under ``precise_stats`` and single-read otherwise
  (``vgg.py:529-533``).
- In training with single-read statistics, the five BN -> pool sites run
  :func:`_bn_pool_fused` (``vgg.py:294-340``): one read of the conv output
  by :func:`fpsg_torch.ops.pool_moments.pool_moments` (kernels K4f/K4b on
  the card) gives the shifted sums and the 2x2 window max and min; the
  BatchNorm takes the statistics by injection, and its affine + relu,
  commuted through the pool, runs on the pooled values in the output
  dtype.
- Elsewhere (eval, ``precise_stats``) every ``"M"`` is the 2x2 max-pool
  kernel (``fpsg_torch/ops/pool.py``), differentiable through the backward
  kernel: one kernel pair for all five sites. (In training under
  ``precise_stats`` the JAX package pools block 1 with the same Pallas pair
  and the other four sites with an XLA custom VJP of the same semantics,
  ``vgg.py:434-480``.)
- The final mean over H, W is taken in f32 (``vgg.py:689``).

Not ported: the space-to-depth execution of block 1 (``vgg.py:41-89,
560-613``) — a TPU lane-filling rewrite of the same conv; the weights keep
their logical ``(64, 3, 3, 3)`` shape here, and block 1's BatchNorms have
no ``phase_groups``. Also not yet ported: ``fused_conv``, ``winograd``,
``stage_slice`` and ``TinyImageEncoder``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from fpsg_torch.nn._init import uniform_fan_in
from fpsg_torch.nn.normalization import BatchNorm
from fpsg_torch.ops.pool import pool2x2
from fpsg_torch.ops.pool_moments import pool_moments

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


def _bn_pool_fused(y: torch.Tensor, fold: torch.Tensor, bn: BatchNorm,
                   out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Training BatchNorm + relu then the 2x2 max-pool of NHWC ``y``, with
    single-read statistics and the affine commuted through the pool:
    ``max_w relu(k y + b) == relu(k [max_w y | min_w y] + b)`` per channel
    (``max`` where ``k > 0``, ``min`` elsewhere), bitwise in any dtype
    because rounding is monotone."""
    b, h, w, c = y.shape
    s = bn.stat_shift(fold)
    zs, zq, ymax, ymin = pool_moments(y.reshape(b, h, w // 2, 2 * c), s)
    n = b * h * w
    mz = zs / n
    var = torch.clamp_min(zq / n - mz * mz, 0.0)
    k, beff = bn.affine_from_stats(mz + s, var, n, shift=fold)  # (C,) f32
    od = out_dtype or y.dtype
    cd = od if od == torch.bfloat16 else k.dtype
    sel = torch.where(k > 0, ymax.to(cd), ymin.to(cd))
    return torch.relu(sel * k.to(cd) + beff.to(cd)).to(od)


class VGG16BN(nn.Module):
    """VGG16-bn feature extractor: (B, H, W, 3) -> (B, 512) f32."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 precise_stats: bool = False):
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
                                          dtype=dtype,
                                          two_pass=precise_stats))
            self._plan.append(("conv", conv, bn))
            in_ch = v
            idx += 3              # conv, bn, relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        plan = self._plan
        i = 0
        while i < len(plan):
            if plan[i][0] == "pool":
                x = pool2x2(x)
                i += 1
                continue
            y, b = getattr(self, plan[i][1])(x)
            bn = getattr(self, plan[i][2])
            if (bn.training and not bn.two_pass and i + 1 < len(plan)
                    and plan[i + 1][0] == "pool"):
                x = _bn_pool_fused(y, b, bn, self.dtype)
                i += 2
                continue
            x = bn(y, shift=b)
            i += 1
        return torch.mean(x.float(), dim=(1, 2))


class ImageEncoder(nn.Module):
    """Backbone selector behind the fixed 512-d interface."""

    def __init__(self, backbone: str = "vgg_16",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 precise_stats: bool = False):
        super().__init__()
        if backbone != "vgg_16":
            raise NotImplementedError(
                f"image encoder backbone {backbone!r} is not ported")
        self.encoder = VGG16BN(dtype, generator, precise_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)
