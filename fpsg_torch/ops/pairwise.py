"""Pairwise squared distances between point sets
(counterpart of ``fpsg_tpu/ops/pairwise.py``).

The expansion ``max((|x|^2 - 2 x.y) + |y|^2, 0)`` in f32, with every
operation rounded on its own in a fixed order: ``|p|^2 = (p0 p0 + p1 p1) +
p2 p2`` and ``x.y = (x0 y0 + x1 y1) + x2 y2`` (summed coordinate by
coordinate for any D). It is the Chamfer nearest-neighbour kernel's exact
definition (``fpsg_torch/csrc/chamfer.cu``), so that kernel agrees with
this function bit for bit. Not ``torch.cdist``: that returns the root and
switches between formulas by size. Elementwise ops rather than a matmul
keep TF32 and the BLAS summation order out of it; the cost is a few
``(..., N, M)`` temporaries, fine at D = 3.
"""

from __future__ import annotations

import torch


def _sqnorm(p: torch.Tensor) -> torch.Tensor:
    acc = p[..., 0] * p[..., 0]
    for k in range(1, p.shape[-1]):
        acc = acc + p[..., k] * p[..., k]
    return acc


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(..., N, D)`` and ``(..., M, D)`` points -> ``(..., N, M)`` squared
    distances, f32."""
    x, y = x.float(), y.float()
    cross = x[..., :, None, 0] * y[..., None, :, 0]
    for k in range(1, x.shape[-1]):
        cross = cross + x[..., :, None, k] * y[..., None, :, k]
    d = (_sqnorm(x)[..., :, None] - 2.0 * cross) + _sqnorm(y)[..., None, :]
    return torch.clamp_min(d, 0.0)
