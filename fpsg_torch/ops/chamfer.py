"""Chamfer distance with the Kaolin convention
(counterpart of ``fpsg_tpu/ops/chamfer.py``).

For clouds ``x (B, N, D)`` and ``y (B, M, D)``::

    CD_b = w1 * mean_i min_j |x_i - y_j|^2  +  w2 * mean_j min_i |x_i - y_j|^2

per batch element, shape ``(B,)`` (the model then ``.sum()``s).

- :func:`nn_both`: the nearest neighbour in both directions, the minimum
  squared distance and the FIRST index attaining it, from one distance
  matrix (``fpsg_torch/ops/pairwise.py:pairwise_sqdist``). Replaces
  ``_nn_pallas_both`` (``chamfer.py:147-201``). Note that the JAX oracle
  ``_nn_oracle_both`` builds a second matrix ``pairwise_sqdist(y, x)``,
  which sums in another order and can differ at near-ties; the port holds
  both its plain version and its kernel to the one-matrix definition.
- :func:`chamfer_distance`: an autograd ``Function`` whose backward is the
  index-routed derivative of the minima (``chamfer.py:226-248``): two
  gathers and two pushes through :func:`fpsg_torch.ops.scatter.segment_sum`.

Kernel ``csrc/chamfer.cu`` (CUDA C++, sm_90a); a CPU tensor runs the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fpsg_torch.ops import count_launch, on_card, register_kernel
from fpsg_torch.ops.pairwise import pairwise_sqdist
from fpsg_torch.ops.scatter import segment_sum

KERNEL = "chamfer_nn"
register_kernel(KERNEL)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fpsg_chamfer_nn": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P]}

NN = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] \
            or x.shape[2] != y.shape[2]:
        raise ValueError(f"expected x (B, N, D), y (B, M, D); got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")


def nn_both_plain(x: torch.Tensor, y: torch.Tensor) -> NN:
    """Plain PyTorch version: ``(min_xy, arg_xy, min_yx, arg_yx)``, f32 and
    int32, (B, N) and (B, M). ``argmin`` returns the first minimal index."""
    d = pairwise_sqdist(x, y)
    return (d.amin(dim=2), d.argmin(dim=2).int(),
            d.amin(dim=1), d.argmin(dim=1).int())


def nn_both_kernel(x: torch.Tensor, y: torch.Tensor) -> NN:
    """Launch the CUDA kernel on contiguous f32 (B, N, 3) CUDA tensors."""
    from fpsg_torch.ops import _build

    _check(x, y)
    if x.shape[2] != 3 or x.dtype != torch.float32 \
            or y.dtype != torch.float32:
        raise ValueError("chamfer_nn kernel takes f32 points with D = 3")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("chamfer_nn kernel needs contiguous tensors")
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    i32 = dict(dtype=torch.int32, device=x.device)
    out = (torch.empty((b, n), **f32), torch.empty((b, n), **i32),
           torch.empty((b, m), **f32), torch.empty((b, m), **i32))
    lib = _build.load("chamfer", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.fpsg_chamfer_nn(x.data_ptr(), y.data_ptr(), b, n, m,
                                  *(t.data_ptr() for t in out),
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fpsg_chamfer_nn")
    count_launch(KERNEL)
    return out


def nn_both(x: torch.Tensor, y: torch.Tensor) -> NN:
    """Nearest neighbours of ``x`` in ``y`` and of ``y`` in ``x``. A CUDA
    tensor launches the kernel; a CPU tensor runs the plain version."""
    if on_card(x, y):
        return nn_both_kernel(x, y)
    _check(x, y)
    return nn_both_plain(x, y)


class _Chamfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, w1: float, w2: float):
        dxy, ixy, dyx, iyx = nn_both(x, y)
        ctx.save_for_backward(x, y, ixy, iyx)
        ctx.weights = (w1, w2)
        return w1 * dxy.mean(dim=-1) + w2 * dyx.mean(dim=-1)

    @staticmethod
    def backward(ctx, g):
        x, y, ixy, iyx = ctx.saved_tensors
        w1, w2 = ctx.weights
        n, m, d = x.shape[1], y.shape[1], x.shape[2]
        gn = (g * (w1 * 2.0 / n)).float()[:, None, None]
        gm = (g * (w2 * 2.0 / m)).float()[:, None, None]
        # x -> y: d/dx_i = 2 (x_i - y_j*) / N, pushed onto y_j* with a minus
        gx1 = gn * (x - torch.gather(y, 1, ixy.long()[..., None].expand(
            -1, -1, d)))
        gy1 = -segment_sum(gx1.contiguous(), ixy, m)
        # y -> x: d/dy_j = 2 (y_j - x_i*) / M, pushed onto x_i*
        gy2 = gm * (y - torch.gather(x, 1, iyx.long()[..., None].expand(
            -1, -1, d)))
        gx2 = -segment_sum(gy2.contiguous(), iyx, n)
        return (gx1 + gx2).to(x.dtype), (gy1 + gy2).to(y.dtype), None, None


def chamfer_distance(x: torch.Tensor, y: torch.Tensor, w1: float = 1.0,
                     w2: float = 1.0) -> torch.Tensor:
    """Kaolin-convention squared Chamfer distance per batch element
    ``(B,)`` of ``x (B, N, D)`` and ``y (B, M, D)`` (2-D inputs are one
    batch element)."""
    if x.dim() == 2:
        x = x[None]
    if y.dim() == 2:
        y = y[None]
    return _Chamfer.apply(x.contiguous(), y.contiguous(), float(w1),
                          float(w2))
