"""One-read BatchNorm moments and per-batch max/min for the PointNet
BN -> global max-pool sites (counterpart of ``fpsg_tpu/ops/moments.py``).

For ``y (B, N, F)`` and the stop-gradient statistics shift ``s (F,)``:

    zsum[f] = sum_{b,n} (y - s),   zsq[f] = sum_{b,n} (y - s)^2,
    ymax[b, f] = max_n y,          ymin[b, f] = min_n y       (f32)

with the FIRST index attaining each max and min (compared in f32): the
backward routes the max/min cotangents there, as torch does on ties
(``moments.py:36-102``; the JAX oracle ``moments_minmax_oracle`` splits
ties instead). The backward is one pass,

    gy = ((A + y * B) + [n == imax] gmax) + [n == imin] gmin,

``A = gzs - 2 s gzq``, ``B = 2 gzq`` per channel, summed in f32 and
rounded once to y's dtype (``moments.py:169-200``). ``s`` gets no
gradient.

Kernels ``csrc/moments.cu`` (CUDA C++, sm_90a): the forward (K3f, replaces
``_moments_fwd_pallas``) reads y once, one block per (cloud, slab of 64
bf16 or 32 f32 channels) walking all N rows, and writes per-cloud partial
sums that a second launch of the same call adds over B in a fixed order:
no float atomics, the same bits on every run. The backward (K3b, replaces
``_moments_bwd_pallas``) is one elementwise pass. Both are bound by bytes.
:func:`moments_minmax` is the differentiable op: a CPU tensor runs the
plain versions below, a CUDA tensor the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fpsg_torch.ops import count_launch, on_card, register_kernel

KERNEL = "moments_fwd"
BWD_KERNEL = "moments_bwd"
register_kernel(KERNEL)
register_kernel(BWD_KERNEL)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fpsg_moments_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _P],
    "fpsg_moments_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _first_index(hit: torch.Tensor) -> torch.Tensor:
    """The first n with ``hit[b, n, f]`` (int32 (B, F)), N where none."""
    n = hit.shape[1]
    rows = torch.arange(n, dtype=torch.int32, device=hit.device)[None, :, None]
    return torch.where(hit, rows, n).amin(dim=1)


def moments_fwd_plain(y: torch.Tensor, s: torch.Tensor):
    """Plain PyTorch version of the forward: ``(zsum, zsq, ymax, imax,
    ymin, imin)``; sums and values f32, indices int32."""
    yf = y.float()
    z = yf - s.float()
    ymax, ymin = yf.amax(dim=1), yf.amin(dim=1)
    return (z.sum(dim=(0, 1)), (z * z).sum(dim=(0, 1)),
            ymax, _first_index(yf == ymax[:, None]),
            ymin, _first_index(yf == ymin[:, None]))


def _coefficients(s, gzs, gzq):
    """Per-channel ``A = gzs - 2 s gzq`` and ``B = 2 gzq`` (f32)."""
    bvec = 2.0 * gzq.float()
    return (gzs.float() - s.float() * bvec).contiguous(), bvec.contiguous()


def moments_bwd_plain(y, s, gzs, gzq, gmax, imax, gmin, imin):
    """Plain PyTorch version of the backward: ``gy`` in y's dtype."""
    avec, bvec = _coefficients(s, gzs, gzq)
    rows = torch.arange(y.shape[1], dtype=torch.int32,
                        device=y.device)[None, :, None]
    gy = avec + y.float() * bvec
    gy = gy + torch.where(rows == imax[:, None], gmax.float()[:, None], 0.0)
    gy = gy + torch.where(rows == imin[:, None], gmin.float()[:, None], 0.0)
    return gy.to(y.dtype)


def _check(y: torch.Tensor, s: torch.Tensor) -> None:
    if y.dim() != 3 or s.shape != (y.shape[2],):
        raise ValueError(f"expected y (B, N, F) and s (F,); got "
                         f"{tuple(y.shape)}, {tuple(s.shape)}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"dtype {y.dtype} not supported (f32, bf16)")


def moments_fwd_kernel(y: torch.Tensor, s: torch.Tensor):
    """Launch K3f on a contiguous CUDA ``y``."""
    from fpsg_torch.ops import _build

    _check(y, s)
    if not y.is_contiguous():
        raise ValueError("moments kernel needs a contiguous (B, N, F) tensor")
    b, n, f = y.shape
    dev = y.device
    sf = s.float().contiguous()
    zs = torch.empty(f, dtype=torch.float32, device=dev)
    zq = torch.empty(f, dtype=torch.float32, device=dev)
    part = torch.empty((2, b, f), dtype=torch.float32, device=dev)
    ymax = torch.empty((b, f), dtype=torch.float32, device=dev)
    ymin = torch.empty((b, f), dtype=torch.float32, device=dev)
    imax = torch.empty((b, f), dtype=torch.int32, device=dev)
    imin = torch.empty((b, f), dtype=torch.int32, device=dev)
    lib = _build.load("moments", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.fpsg_moments_fwd(
            _DTYPES[y.dtype], y.data_ptr(), sf.data_ptr(), zs.data_ptr(),
            zq.data_ptr(), part.data_ptr(), ymax.data_ptr(), imax.data_ptr(),
            ymin.data_ptr(), imin.data_ptr(), b, n, f,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fpsg_moments_fwd")
    count_launch(KERNEL)
    return zs, zq, ymax, imax, ymin, imin


def moments_bwd_kernel(y, s, gzs, gzq, gmax, imax, gmin, imin):
    """Launch K3b on contiguous CUDA tensors."""
    from fpsg_torch.ops import _build

    _check(y, s)
    if not y.is_contiguous():
        raise ValueError("moments kernel needs a contiguous (B, N, F) tensor")
    b, n, f = y.shape
    avec, bvec = _coefficients(s, gzs, gzq)
    gmax, gmin = gmax.float().contiguous(), gmin.float().contiguous()
    imax, imin = imax.contiguous(), imin.contiguous()
    gy = torch.empty_like(y)
    lib = _build.load("moments", _SIGNATURES)
    with torch.cuda.device(y.device):
        err = lib.fpsg_moments_bwd(
            _DTYPES[y.dtype], y.data_ptr(), avec.data_ptr(), bvec.data_ptr(),
            gmax.data_ptr(), imax.data_ptr(), gmin.data_ptr(),
            imin.data_ptr(), gy.data_ptr(), b, n, f,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fpsg_moments_bwd")
    count_launch(BWD_KERNEL)
    return gy


def moments_fwd(y: torch.Tensor, s: torch.Tensor):
    """``(zsum, zsq, ymax, imax, ymin, imin)`` of ``y``: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if on_card(y, s):
        return moments_fwd_kernel(y, s)
    _check(y, s)
    return moments_fwd_plain(y, s)


def moments_bwd(y, s, gzs, gzq, gmax, imax, gmin, imin) -> torch.Tensor:
    """``gy`` of the forward's four outputs' cotangents: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if on_card(y, imax, imin):
        return moments_bwd_kernel(y, s, gzs, gzq, gmax, imax, gmin, imin)
    _check(y, s)
    return moments_bwd_plain(y, s, gzs, gzq, gmax, imax, gmin, imin)


class _MomentsMinMax(torch.autograd.Function):
    """Saves y, s and the indices; the backward never recomputes a max."""

    @staticmethod
    def forward(ctx, y, s):
        zs, zq, ymax, imax, ymin, imin = moments_fwd(y, s)
        ctx.save_for_backward(y, s, imax, imin)
        return zs, zq, ymax, ymin

    @staticmethod
    def backward(ctx, gzs, gzq, gmax, gmin):
        y, s, imax, imin = ctx.saved_tensors
        return moments_bwd(y, s, gzs, gzq, gmax, imax, gmin, imin), None


def moments_minmax(y: torch.Tensor, s: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """``(zsum (F,), zsq (F,), ymax (B, F), ymin (B, F))`` of ``y (B, N,
    F)`` with ``z = y - s``, differentiable in ``y`` (first-index routing
    of the max/min cotangents)."""
    return _MomentsMinMax.apply(y.contiguous(), s.detach())
