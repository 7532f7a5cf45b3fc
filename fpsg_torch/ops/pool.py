"""2x2/stride-2 max-pool of an NHWC tensor with the first-match window code,
and its backward.

The forward replaces ``fpsg_tpu/nn/vgg.py:_pool_pallas_fwd`` (kernel
``_pool_fwd_kernel``), the backward ``_pool_pallas_bwd`` (kernel
``_pool_bwd_kernel``). The TPU kernels read VGG block 1's width-packed
``(B, H, W/2, 2C)`` layout; the port drops that packing, so
``x.reshape(b, h, w // 2, 2 * c)`` of the NHWC input here is literally the
TPU kernels' input, and one kernel pair serves all five VGG pool sites.

Semantics (``vgg.py:108-117``, ``ops/_pallas_utils.py:52-70``): window
elements in torch's row-major (dh, dw) order, ``y = max`` of the four, and
the int8 code = the FIRST window index whose value equals ``y``, compared
in f32. Ties therefore route to the first maximal element, bit for bit.

The backward routes the cotangent ``g`` of ``y`` to the window position
the code names and writes 0 at the other three (``vgg.py:460-477``), so
ties send the whole gradient to the first maximal element, as torch does.
:func:`pool2x2` is the differentiable pool: an autograd ``Function`` whose
forward saves the codes and whose backward is the backward kernel; the
input is never read again.

Kernels ``csrc/maxpool2x2.cu`` (CUDA C++, sm_90a): one thread per 16 bytes
of channels of one pooled pixel (4 f32 or 8 bf16 channels), 16-byte loads
and stores. Bound by bytes: the forward reads x once and writes a quarter
of it (plus a sixteenth in int8 codes when asked for); the backward reads
g and the codes and writes gx, four times g's size.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from fpsg_torch.ops import count_launch, on_card, register_kernel

KERNEL = "maxpool2x2"
BWD_KERNEL = "maxpool2x2_bwd"
register_kernel(KERNEL)
register_kernel(BWD_KERNEL)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "fpsg_maxpool2x2": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "fpsg_maxpool2x2_bwd": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _window_elems(x: torch.Tensor):
    """The four 2x2-window elements of NHWC ``x`` as quarter-size views,
    in torch's row-major (dh, dw) scan order."""
    b, h, w, c = x.shape
    x6 = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return [x6[:, :, dh, :, dw, :] for dh in (0, 1) for dw in (0, 1)]


def maxpool2x2_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(y, code)`` with code int8 in 0..3."""
    e = _window_elems(x)
    y = torch.maximum(torch.maximum(e[0], e[1]), torch.maximum(e[2], e[3]))
    ef = [t.float() for t in e]
    yf = y.float()
    code = torch.where(
        ef[0] == yf, 0,
        torch.where(ef[1] == yf, 1, torch.where(ef[2] == yf, 2, 3)))
    return y, code.to(torch.int8)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected NHWC (B, H, W, C), got {tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"2x2 pool needs even H, W; got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} not supported (f32, bf16)")


def maxpool2x2_kernel(x: torch.Tensor, return_index: bool = False):
    """Launch the CUDA kernel on a contiguous NHWC CUDA tensor."""
    from fpsg_torch.ops import _build

    _check(x)
    if not x.is_contiguous():
        raise ValueError("maxpool2x2 kernel needs a contiguous NHWC tensor")
    b, h, w, c = x.shape
    y = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    idx = torch.empty(y.shape, dtype=torch.int8, device=x.device) \
        if return_index else None
    lib = _build.load("maxpool2x2", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = lib.fpsg_maxpool2x2(
            _DTYPES[x.dtype], x.data_ptr(), y.data_ptr(),
            idx.data_ptr() if idx is not None else None, b, h, w, c,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "fpsg_maxpool2x2")
    count_launch(KERNEL)
    return (y, idx) if return_index else y


def maxpool2x2(x: torch.Tensor, return_index: bool = False
               ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """2x2/2 max-pool of NHWC ``x``: ``y`` ``(B, H/2, W/2, C)``, and with
    ``return_index`` also the int8 first-match window code.

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    """
    if on_card(x):
        return maxpool2x2_kernel(x, return_index)
    _check(x)
    y, code = maxpool2x2_plain(x)
    return (y, code) if return_index else y


def maxpool2x2_bwd_plain(g: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: ``gx`` (B, 2*H2, 2*W2, C)."""
    b, h2, w2, c = g.shape
    pos = torch.arange(4, dtype=torch.int8, device=g.device).view(
        1, 1, 2, 1, 2, 1)                       # 2 * dh + dw
    gx6 = torch.where(code[:, :, None, :, None, :] == pos,
                      g[:, :, None, :, None, :], 0)
    return gx6.reshape(b, 2 * h2, 2 * w2, c)


def _check_bwd(g: torch.Tensor, code: torch.Tensor) -> None:
    if g.dim() != 4 or code.shape != g.shape or code.dtype != torch.int8:
        raise ValueError(f"expected g (B, H2, W2, C) and int8 codes of its "
                         f"shape; got {tuple(g.shape)}, {tuple(code.shape)} "
                         f"{code.dtype}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"dtype {g.dtype} not supported (f32, bf16)")


def maxpool2x2_bwd_kernel(g: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel on contiguous CUDA tensors."""
    from fpsg_torch.ops import _build

    _check_bwd(g, code)
    if not (g.is_contiguous() and code.is_contiguous()):
        raise ValueError("maxpool2x2_bwd kernel needs contiguous tensors")
    b, h2, w2, c = g.shape
    gx = torch.empty((b, 2 * h2, 2 * w2, c), dtype=g.dtype, device=g.device)
    lib = _build.load("maxpool2x2", _SIGNATURES)
    with torch.cuda.device(g.device):
        err = lib.fpsg_maxpool2x2_bwd(
            _DTYPES[g.dtype], g.data_ptr(), code.data_ptr(), gx.data_ptr(),
            b, 2 * h2, 2 * w2, c, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fpsg_maxpool2x2_bwd")
    count_launch(BWD_KERNEL)
    return gx


def maxpool2x2_bwd(g: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Gradient of the pool's input from ``g`` (B, H/2, W/2, C) and the
    forward's codes. A CUDA tensor launches the kernel; a CPU tensor runs
    the plain version."""
    if on_card(g, code):
        return maxpool2x2_bwd_kernel(g, code)
    _check_bwd(g, code)
    return maxpool2x2_bwd_plain(g, code)


class _Pool2x2(torch.autograd.Function):
    """The pool with its codes saved for the backward kernel."""

    @staticmethod
    def forward(ctx, x):
        y, code = maxpool2x2(x, return_index=True)
        ctx.save_for_backward(code)
        return y

    @staticmethod
    def backward(ctx, g):
        (code,) = ctx.saved_tensors
        return maxpool2x2_bwd(g.contiguous(), code)


def pool2x2(x: torch.Tensor) -> torch.Tensor:
    """Differentiable 2x2/2 max-pool of NHWC ``x``. When autograd will need
    the gradient, the forward keeps the int8 codes and the backward routes
    by them (:func:`maxpool2x2_bwd`); otherwise no codes are made."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Pool2x2.apply(x)
    return maxpool2x2(x)
