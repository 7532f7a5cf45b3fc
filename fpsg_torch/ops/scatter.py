"""Batched point segment sum (counterpart of ``fpsg_tpu/ops/scatter.py``).

``out[b, j] = sum over i with idx[b, i] == j of vals[b, i]``: the Chamfer
backward pushes per-point cotangents onto their nearest neighbours with it.
Replaces ``fpsg_tpu/ops/scatter.py:_segment_sum_pallas``, the TPU's dense
one-hot mask kernel.

Kernel ``csrc/segment_sum.cu`` (CUDA C++, sm_90a): deterministic, no
atomics. One thread per output row scans the batch's indices in increasing
order and adds the matching values in that order, so the sum has the order
of a sequential CPU ``index_add_`` (the plain version on the CPU) and the
result never changes from run to run. On the card the plain version is
``index_add_`` with float atomics, whose order varies: compare the two
within a bound there, not bitwise. Indices outside ``[0, size)`` are
dropped by the kernel, as by the TPU's mask; the plain version raises on
them.
"""

from __future__ import annotations

import ctypes

import torch

from fpsg_torch.ops import count_launch, on_card, register_kernel

KERNEL = "segment_sum"
register_kernel(KERNEL)

MAX_D = 8          # csrc/segment_sum.cu: value width held in registers
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fpsg_segment_sum": [_P, _P, _P, _I, _I, _I, _I, _P]}


def _check(vals: torch.Tensor, idx: torch.Tensor, size: int) -> None:
    if vals.dim() != 3 or idx.shape != vals.shape[:2]:
        raise ValueError(f"expected vals (B, N, D) and idx (B, N); got "
                         f"{tuple(vals.shape)}, {tuple(idx.shape)}")
    if vals.dtype != torch.float32:
        raise TypeError(f"segment_sum: vals must be f32, got {vals.dtype}")
    if not 1 <= vals.shape[2] <= MAX_D or size < 0:
        raise ValueError(f"segment_sum: D = {vals.shape[2]} (1..{MAX_D}), "
                         f"size = {size}")


def segment_sum_plain(vals: torch.Tensor, idx: torch.Tensor,
                      size: int) -> torch.Tensor:
    """Plain PyTorch version: ``(B, size, D)`` f32."""
    b, n, d = vals.shape
    flat = (idx.long() + size * torch.arange(b, device=idx.device)[:, None])
    out = torch.zeros((b * size, d), dtype=torch.float32, device=vals.device)
    out.index_add_(0, flat.reshape(-1), vals.reshape(b * n, d))
    return out.reshape(b, size, d)


def segment_sum_kernel(vals: torch.Tensor, idx: torch.Tensor,
                       size: int) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous CUDA tensors (idx int32)."""
    from fpsg_torch.ops import _build

    _check(vals, idx, size)
    if idx.dtype != torch.int32:
        raise TypeError(f"segment_sum kernel: idx must be int32, got "
                        f"{idx.dtype}")
    if not (vals.is_contiguous() and idx.is_contiguous()):
        raise ValueError("segment_sum kernel needs contiguous tensors")
    b, n, d = vals.shape
    out = torch.empty((b, size, d), dtype=torch.float32, device=vals.device)
    lib = _build.load("segment_sum", _SIGNATURES)
    with torch.cuda.device(vals.device):
        err = lib.fpsg_segment_sum(vals.data_ptr(), idx.data_ptr(),
                                   out.data_ptr(), b, n, size, d,
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fpsg_segment_sum")
    count_launch(KERNEL)
    return out


def segment_sum(vals: torch.Tensor, idx: torch.Tensor,
                size: int) -> torch.Tensor:
    """Scatter ``(B, N, D)`` f32 ``vals`` into ``(B, size, D)`` at ``idx``
    ``(B, N)`` (values in ``[0, size)``). A CUDA tensor launches the
    kernel; a CPU tensor runs the plain version."""
    if on_card(vals, idx):
        return segment_sum_kernel(vals, idx, size)
    _check(vals, idx, size)
    return segment_sum_plain(vals, idx, size)
