"""One-read BatchNorm moments and 2x2 max/min pool for the VGG BN -> pool
sites (counterpart of ``fpsg_tpu/ops/pool_moments.py``).

The input is the width-packed view ``y (B, H, W/2, 2C)`` of an NHWC conv
output, the free reshape ``x.reshape(b, h, w // 2, 2 * c)`` (packed channel
``dw * C + c``): the 2x2 window is (row pair) x (channel phase), its
elements in torch's row-major (dh, dw) order, code ``2 dh + dw``
(``ops/_pallas_utils.py:52-70``, the codes of ``ops/pool.py``). For the
stop-gradient statistics shift ``s (C,)`` and ``z = y - s``:

    zsum[c], zsq[c]: sum of z and z^2 over (B, H, W), both phases folded
    ymax, ymin (B, H/2, W/2, C), y's dtype: the window max and min
    imax, imin: int8 codes of the FIRST window element equal to each,
                compared in f32

(``pool_moments.py:45-103``; the JAX function returns the statistics at
packed width ``2C`` and its caller folds the phases, ``vgg.py:321-324``:
the same sums in another order). The backward is one pass
(``pool_moments.py:179-207``),

    gy = (A + y * B) + ([code_max == t] gmax + [code_min == t] gmin)

at window position ``t``, ``A = gzs - 2 s gzq``, ``B = 2 gzq`` per
channel, in f32, rounded once to y's dtype. ``s`` gets no gradient.

Kernels ``csrc/pool_moments.cu`` (CUDA C++, sm_90a): the forward (K4f,
replaces ``_fwd_pallas``) and the backward (K4b, replaces
``_bwd_pallas``), each one pass over y, bound by bytes; the forward's sums
are per-block partials added in a fixed order (no float atomics).
:func:`pool_moments` is the differentiable op: a CPU tensor runs the plain
versions below, a CUDA tensor the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fpsg_torch.ops import count_launch, on_card, register_kernel

KERNEL = "pool_moments_fwd"
BWD_KERNEL = "pool_moments_bwd"
register_kernel(KERNEL)
register_kernel(BWD_KERNEL)

MAX_GROUPS = 132 * 8   # csrc/pool_moments.cu: pixel groups (partial sums)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fpsg_pool_moments_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _P],
    "fpsg_pool_moments_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _P],
}


def _windows(y: torch.Tensor):
    """The four window elements of packed ``y`` as (B, H/2, W/2, C) views,
    in (dh, dw) order."""
    b, h, w2, c2 = y.shape
    y6 = y.reshape(b, h // 2, 2, w2, 2, c2 // 2)
    return [y6[:, :, dh, :, dw, :] for dh in (0, 1) for dw in (0, 1)]


def _first_match(ef, target):
    """int8 code of the first of the four f32 elements equal to target."""
    return torch.where(ef[0] == target, 0, torch.where(
        ef[1] == target, 1, torch.where(ef[2] == target, 2, 3))).to(torch.int8)


def pool_moments_fwd_plain(y: torch.Tensor, s: torch.Tensor):
    """Plain PyTorch version of the forward: ``(zsum, zsq, ymax, imax,
    ymin, imin)``."""
    b, h, w2, c2 = y.shape
    z = y.float().reshape(-1, c2 // 2) - s.float()
    e = _windows(y)
    ymax = torch.maximum(torch.maximum(e[0], e[1]), torch.maximum(e[2], e[3]))
    ymin = torch.minimum(torch.minimum(e[0], e[1]), torch.minimum(e[2], e[3]))
    ef = [t.float() for t in e]
    return (z.sum(dim=0), (z * z).sum(dim=0),
            ymax, _first_match(ef, ymax.float()),
            ymin, _first_match(ef, ymin.float()))


def _coefficients(s, gzs, gzq):
    bvec = 2.0 * gzq.float()
    return (gzs.float() - s.float() * bvec).contiguous(), bvec.contiguous()


def pool_moments_bwd_plain(y, s, gzs, gzq, gmax, imax, gmin, imin):
    """Plain PyTorch version of the backward: ``gy`` (packed, y's dtype)."""
    b, h, w2, c2 = y.shape
    avec, bvec = _coefficients(s, gzs, gzq)
    y6 = y.reshape(b, h // 2, 2, w2, 2, c2 // 2).float()
    pos = torch.arange(4, dtype=torch.int8, device=y.device).view(
        1, 1, 2, 1, 2, 1)                                     # 2 * dh + dw

    def spread(code, g):
        return torch.where(code[:, :, None, :, None, :] == pos,
                           g.float()[:, :, None, :, None, :], 0.0)

    gy = (avec + y6 * bvec) + (spread(imax, gmax) + spread(imin, gmin))
    return gy.to(y.dtype).reshape(b, h, w2, c2)


def _check(y: torch.Tensor, s: torch.Tensor) -> None:
    if y.dim() != 4 or y.shape[1] % 2 or y.shape[3] % 2:
        raise ValueError(f"expected packed y (B, H, W/2, 2C) with even H; "
                         f"got {tuple(y.shape)}")
    if s.shape != (y.shape[3] // 2,):
        raise ValueError(f"s must be (C,) = ({y.shape[3] // 2},), got "
                         f"{tuple(s.shape)}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"dtype {y.dtype} not supported (f32, bf16)")


def pool_moments_fwd_kernel(y: torch.Tensor, s: torch.Tensor):
    """Launch K4f on a contiguous CUDA ``y``."""
    from fpsg_torch.ops import _build

    _check(y, s)
    if not y.is_contiguous():
        raise ValueError("pool_moments kernel needs a contiguous tensor")
    b, h, w2, c2 = y.shape
    c, dev = c2 // 2, y.device
    sf = s.float().contiguous()
    zs = torch.empty(c, dtype=torch.float32, device=dev)
    zq = torch.empty(c, dtype=torch.float32, device=dev)
    pooled = (b, h // 2, w2, c)
    ymax = torch.empty(pooled, dtype=y.dtype, device=dev)
    ymin = torch.empty(pooled, dtype=y.dtype, device=dev)
    imax = torch.empty(pooled, dtype=torch.int8, device=dev)
    imin = torch.empty(pooled, dtype=torch.int8, device=dev)
    part = torch.empty((2, MAX_GROUPS, c), dtype=torch.float32, device=dev)
    lib = _build.load("pool_moments", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.fpsg_pool_moments_fwd(
            _DTYPES[y.dtype], y.data_ptr(), sf.data_ptr(), zs.data_ptr(),
            zq.data_ptr(), part.data_ptr(), ymax.data_ptr(), imax.data_ptr(),
            ymin.data_ptr(), imin.data_ptr(), b, h, 2 * w2, c, MAX_GROUPS,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fpsg_pool_moments_fwd")
    count_launch(KERNEL)
    return zs, zq, ymax, imax, ymin, imin


def pool_moments_bwd_kernel(y, s, gzs, gzq, gmax, imax, gmin, imin):
    """Launch K4b on contiguous CUDA tensors."""
    from fpsg_torch.ops import _build

    _check(y, s)
    if not y.is_contiguous():
        raise ValueError("pool_moments kernel needs a contiguous tensor")
    b, h, w2, c2 = y.shape
    avec, bvec = _coefficients(s, gzs, gzq)
    gmax, gmin = gmax.contiguous(), gmin.contiguous()
    imax, imin = imax.contiguous(), imin.contiguous()
    if gmax.dtype != y.dtype or gmin.dtype != y.dtype:
        raise TypeError("pool_moments_bwd: max/min cotangents in y's dtype")
    gy = torch.empty_like(y)
    lib = _build.load("pool_moments", _SIGNATURES)
    with torch.cuda.device(y.device):
        err = lib.fpsg_pool_moments_bwd(
            _DTYPES[y.dtype], y.data_ptr(), avec.data_ptr(), bvec.data_ptr(),
            gmax.data_ptr(), imax.data_ptr(), gmin.data_ptr(),
            imin.data_ptr(), gy.data_ptr(), b, h, 2 * w2, c2 // 2,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fpsg_pool_moments_bwd")
    count_launch(BWD_KERNEL)
    return gy


def pool_moments_fwd(y: torch.Tensor, s: torch.Tensor):
    """``(zsum, zsq, ymax, imax, ymin, imin)`` of packed ``y``: the kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if on_card(y, s):
        return pool_moments_fwd_kernel(y, s)
    _check(y, s)
    return pool_moments_fwd_plain(y, s)


def pool_moments_bwd(y, s, gzs, gzq, gmax, imax, gmin, imin) -> torch.Tensor:
    """``gy`` of the forward's four outputs' cotangents: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if on_card(y, imax, imin):
        return pool_moments_bwd_kernel(y, s, gzs, gzq, gmax, imax, gmin, imin)
    _check(y, s)
    return pool_moments_bwd_plain(y, s, gzs, gzq, gmax, imax, gmin, imin)


class _PoolMoments(torch.autograd.Function):
    """Saves y, s and the codes; the backward never recomputes a max."""

    @staticmethod
    def forward(ctx, y, s):
        zs, zq, ymax, imax, ymin, imin = pool_moments_fwd(y, s)
        ctx.save_for_backward(y, s, imax, imin)
        return zs, zq, ymax, ymin

    @staticmethod
    def backward(ctx, gzs, gzq, gmax, gmin):
        y, s, imax, imin = ctx.saved_tensors
        return pool_moments_bwd(y, s, gzs, gzq, gmax, imax, gmin, imin), None


def pool_moments(y: torch.Tensor, s: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """``(zsum (C,), zsq (C,), ymax, ymin (B, H/2, W/2, C))`` of the packed
    ``y (B, H, W/2, 2C)`` with ``z = y - s``, differentiable in ``y``
    (first-match routing of the max/min cotangents)."""
    return _PoolMoments.apply(y.contiguous(), s.detach())
