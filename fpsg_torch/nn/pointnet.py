"""PointNet encoder (counterpart of ``fpsg_tpu/nn/pointnet.py``).

Points are ``(B, N, 3)`` channels-last; every 1x1 conv is a dense layer on
the channel axis. Dense weights use torch's ``(out, in)`` layout (the
bridge transposes the JAX ``(in, out)`` kernels). Each dense bias before a
BatchNorm folds into it (``shift=``).

The BN -> global max-pool sites commute the per-channel affine through the
max (``_bn_maxpool``, ``pointnet.py:117-155``):
``max_n act(k*y + b) == act(k*[max_n y | min_n y] + b)``, picking ``ymax``
where ``k > 0`` and ``ymin`` elsewhere (``k == 0`` takes ``ymin``). In
training the affine comes from ``y``'s batch statistics:

- single-read (``precise_stats=False``, the default): one read of ``y`` by
  :func:`fpsg_torch.ops.moments.moments_minmax` (kernel K3 on the card)
  gives the shifted sums and the per-cloud max/min; the BatchNorm takes
  the statistics by injection. The max/min gradient goes to the first
  index attaining it.
- ``precise_stats``: the two-pass statistics of the BatchNorm, and
  ``amax``/``amin``, which split a tied maximum's gradient evenly, as
  ``jnp.max`` does.

Every BatchNorm of the encoder is two-pass exactly under
``precise_stats`` (``pointnet.py:172, 247-261``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fpsg_torch.nn._init import uniform_fan_in
from fpsg_torch.nn.normalization import BatchNorm
from fpsg_torch.ops.moments import moments_minmax


class DenseFold(nn.Module):
    """Dense layer whose bias is returned for the next BatchNorm to fold."""

    def __init__(self, d_in: int, d_out: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(uniform_fan_in((d_out, d_in), d_in,
                                                  generator))
        self.bias = nn.Parameter(uniform_fan_in((d_out,), d_in, generator))

    def forward(self, x: torch.Tensor):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt)), self.bias


class Dense(DenseFold):
    """Dense layer with its bias applied (flax ``nn.Dense``)."""

    def forward(self, x: torch.Tensor):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def bn_maxpool(y: torch.Tensor, b: torch.Tensor, bn: BatchNorm, relu: bool,
               out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """BatchNorm (+relu) then max over the points axis of ``y`` (B, N, F),
    with the affine commuted through the max."""
    if bn.training and not bn.two_pass:
        s = bn.stat_shift(b)
        zs, zq, ymax, ymin = moments_minmax(y, s)     # one read of y
        n = y.shape[0] * y.shape[1]
        mz = zs / n
        var = torch.clamp_min(zq / n - mz * mz, 0.0)
        k, beff = bn.affine_from_stats(mz + s, var, n, shift=b)
    else:
        k, beff = bn.affine(shift=b, x=y)              # (F,) f32
        yf = y.float()                                 # one f32 copy
        ymax = torch.amax(yf, dim=1)                   # (B, F)
        ymin = torch.amin(yf, dim=1)
    od = out_dtype or y.dtype
    cd = od if od == torch.bfloat16 else k.dtype
    sel = torch.where(k > 0, ymax, ymin).to(cd)
    pooled = sel * k.to(cd) + beff.to(cd)
    if relu:
        pooled = torch.relu(pooled)
    return pooled.to(od)


class STN3d(nn.Module):
    """Spatial transformer predicting a 3x3 alignment."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 precise_stats: bool = False):
        super().__init__()
        self.dtype = dtype
        g = generator
        self.conv1 = DenseFold(3, 64, dtype, g)
        self.conv2 = DenseFold(64, 128, dtype, g)
        self.conv3 = DenseFold(128, 1024, dtype, g)
        self.fc1 = DenseFold(1024, 512, dtype, g)
        self.fc2 = DenseFold(512, 256, dtype, g)
        self.fc3 = Dense(256, 9, dtype, g)
        for i, f in enumerate((64, 128, 1024, 512, 256), start=1):
            self.add_module(f"bn{i}", BatchNorm((f,), activation="relu",
                                                dtype=dtype,
                                                two_pass=precise_stats))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(*self.conv1(x))
        h = self.bn2(*self.conv2(h))
        y, b = self.conv3(h)
        h = bn_maxpool(y, b, self.bn3, True, self.dtype)       # (B, 1024)
        h = self.bn4(*self.fc1(h))
        h = self.bn5(*self.fc2(h))
        h = self.fc3(h).float()
        iden = torch.eye(3, dtype=h.dtype, device=h.device).reshape(9)
        return (h + iden).reshape(-1, 3, 3)


class PointNetFeat(nn.Module):
    """Global 1024-d PointNet feature (``feature_transform=False``)."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 precise_stats: bool = False):
        super().__init__()
        self.dtype = dtype
        g = generator
        self.stn = STN3d(dtype, g, precise_stats)
        self.conv1 = DenseFold(3, 64, dtype, g)
        self.conv2 = DenseFold(64, 128, dtype, g)
        self.conv3 = DenseFold(128, 1024, dtype, g)
        bn = dict(dtype=dtype, two_pass=precise_stats)
        self.bn1 = BatchNorm((64,), activation="relu", **bn)
        self.bn2 = BatchNorm((128,), activation="relu", **bn)
        self.bn3 = BatchNorm((1024,), **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        trans = self.stn(x)
        x = torch.bmm(x.float(), trans)                        # bnd,bde->bne
        x = self.bn1(*self.conv1(x))
        x = self.bn2(*self.conv2(x))
        y, b = self.conv3(x)
        return bn_maxpool(y, b, self.bn3, False, self.dtype).float()


class PointNetEncoder(nn.Module):
    """``PCEncoder(core='pointnet')``: (B, N, 3) -> (B, 1024) f32."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 precise_stats: bool = False):
        super().__init__()
        self.pointnet_feat_extractor = PointNetFeat(dtype, generator,
                                                    precise_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointnet_feat_extractor(x)
