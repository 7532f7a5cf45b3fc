"""Fused layers of the stacked primitive-node MLP chain, eval form
(counterpart of ``fpsg_tpu/nn/fused_stack.py`` with ``with_stats=False``).

Layout as in the JAX package: activations group-major ``(C, Nn, R, D)``
with ``R = B * P`` rows (B clouds x P points per node), weights ``(C, Nn,
Din, Dout)``, the previous BN's collapsed affine ``k``/``b`` as ``(C, Nn,
D)`` f32. Each layer reads its input once and writes its output once:

- ``fused_l1_layer``: ``y = d @ Wd + y_cond[row // P]``. Replaces
  ``_fused_l1_fwd`` (``fused_stack.py:525-551``). K = raw_dim = 3, so it is
  bound by the bytes of y it writes. The conditioning is added in f32 and
  y rounds once to the activation dtype.
- ``fused_mid_layer``: ``y = relu(k * yp + b) @ W`` per (cluster, node),
  f32 accumulation, one rounding. Replaces ``_fused_mid_fwd``
  (``:308-332``). A batched GEMM of C*Nn groups with the BN affine and relu
  applied as the A tile is loaded; bound by operations (1539 -> 769 is
  ~39 GFLOP at Q=8).
- ``fused_out_layer``: ``tanh(relu(k * yp + b) @ W + bias)``, f32 out.
  Replaces ``_fused_out_fwd`` (``:676-693``). N = raw_dim = 3, so it is
  bound by the bytes of yp it reads.

The affine is applied in the activation dtype, as the TPU kernels do
(``k``/``b`` cast to it, one rounding after the multiply and one after the
add); products accumulate in f32.

Not ported: the 3 -> 8 lane padding of raw_dim (``decoder.py:353,362-365,
423-424``) and the Mosaic row tiles (``_row_tile``) are TPU layout
constraints; the ``with_stats`` epilogues and the backward kernels come
with the training slice.

Kernels: ``csrc/fused_stack.cu`` (CUDA C++, sm_90a). A CUDA tensor launches
the kernel; a CPU tensor runs the plain version below.
"""

from __future__ import annotations

import ctypes

import torch

from fpsg_torch.ops import count_launch, on_card, register_kernel

L1, MID, OUT = "fused_l1", "fused_mid", "fused_out"
for _name in (L1, MID, OUT):
    register_kernel(_name)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fpsg_fused_l1_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fpsg_fused_mid_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fpsg_fused_out_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}
MAX_L1_DIN = 8     # csrc/fused_stack.cu: L1 point width held in registers
MAX_OUT_DOUT = 8   # csrc/fused_stack.cu: output width held in registers


def _lib():
    from fpsg_torch.ops import _build

    return _build, _build.load("fused_stack", _SIGNATURES)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_common(name, x, w, k=None, b=None):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (f32, bf16)")
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: weight dtype {w.dtype} != {x.dtype}")
    c, nn_, _, din = x.shape
    if w.shape[:3] != (c, nn_, din):
        raise ValueError(f"{name}: weight {tuple(w.shape)} for input "
                         f"{tuple(x.shape)}")
    for v in (k, b):
        if v is not None and (v.shape != (c, nn_, din)
                              or v.dtype != torch.float32):
            raise ValueError(f"{name}: affine must be f32 {(c, nn_, din)}, "
                             f"got {v.dtype} {tuple(v.shape)}")


def _affine_relu(yp, k, b):
    """relu(k * yp + b) in yp's dtype, per (cluster, node, channel)."""
    dt = yp.dtype
    return torch.relu(yp * k.to(dt)[:, :, None, :] + b.to(dt)[:, :, None, :])


# --- layer 1 ---------------------------------------------------------------

def fused_l1_plain(d, wd, y_cond, p: int):
    """Plain PyTorch version of :func:`fused_l1_layer`."""
    yc = y_cond.float().repeat_interleave(p, dim=2)
    return (torch.matmul(d.float(), wd.float()) + yc).to(d.dtype)


def fused_l1_kernel(d, wd, y_cond, p: int):
    build, lib = _lib()
    c, nn_, r, din = d.shape
    dout = wd.shape[-1]
    y = torch.empty((c, nn_, r, dout), dtype=d.dtype, device=d.device)
    with torch.cuda.device(d.device):
        code = lib.fpsg_fused_l1_fwd(
            _DTYPES[d.dtype], d.data_ptr(), wd.data_ptr(), y_cond.data_ptr(),
            y.data_ptr(), c * nn_, r, p, din, dout, _stream())
    build.check(lib, code, "fpsg_fused_l1_fwd")
    count_launch(L1)
    return y


def fused_l1_layer(d, wd, y_cond, p: int):
    """``d @ wd + y_cond`` per cloud.

    Args:
      d: (C, Nn, R, Din) deformed template points, R = B * p, Din <= 8.
      wd: (C, Nn, Din, Dout) point rows of the node_conv1 kernel, d's dtype.
      y_cond: (C, Nn, B, Dout) f32 hoisted conditioning matmul output.
      p: points per cloud.
    Returns: (C, Nn, R, Dout) in d's dtype.
    """
    _check_common("fused_l1_layer", d, wd)
    c, nn_, r, din = d.shape
    if r % p or y_cond.shape != (c, nn_, r // p, wd.shape[-1]) \
            or y_cond.dtype != torch.float32:
        raise ValueError(f"fused_l1_layer: y_cond {y_cond.dtype} "
                         f"{tuple(y_cond.shape)} for R={r}, p={p}")
    if din > MAX_L1_DIN:
        raise ValueError(f"fused_l1_layer: Din {din} > {MAX_L1_DIN}")
    if on_card(d, wd, y_cond):
        return fused_l1_kernel(d.contiguous(), wd.contiguous(),
                               y_cond.contiguous(), p)
    return fused_l1_plain(d, wd, y_cond, p)


# --- mid layers ------------------------------------------------------------

def fused_mid_plain(yp, k, b, w):
    """Plain PyTorch version of :func:`fused_mid_layer`."""
    a = _affine_relu(yp, k, b)
    return torch.matmul(a.float(), w.float()).to(yp.dtype)


def fused_mid_kernel(yp, k, b, w):
    build, lib = _lib()
    c, nn_, r, din = yp.shape
    dout = w.shape[-1]
    y = torch.empty((c, nn_, r, dout), dtype=yp.dtype, device=yp.device)
    with torch.cuda.device(yp.device):
        code = lib.fpsg_fused_mid_fwd(
            _DTYPES[yp.dtype], yp.data_ptr(), k.data_ptr(), b.data_ptr(),
            w.data_ptr(), y.data_ptr(), c * nn_, r, din, dout, _stream())
    build.check(lib, code, "fpsg_fused_mid_fwd")
    count_launch(MID)
    return y


def fused_mid_layer(yp, k, b, w):
    """``relu(k * yp + b) @ w`` per (cluster, node).

    Args:
      yp: (C, Nn, R, Din) previous layer's raw output.
      k, b: (C, Nn, Din) f32, the previous BN's collapsed affine.
      w: (C, Nn, Din, Dout) in yp's dtype.
    Returns: (C, Nn, R, Dout) in yp's dtype.
    """
    _check_common("fused_mid_layer", yp, w, k, b)
    if on_card(yp, k, b, w):
        return fused_mid_kernel(yp.contiguous(), k.contiguous(),
                                b.contiguous(), w.contiguous())
    return fused_mid_plain(yp, k, b, w)


# --- output layer ----------------------------------------------------------

def fused_out_plain(yp, k, b, w, bias):
    """Plain PyTorch version of :func:`fused_out_layer`."""
    a = _affine_relu(yp, k, b)
    t = torch.matmul(a.float(), w.float()) + bias.float()[:, :, None, :]
    return torch.tanh(t)


def fused_out_kernel(yp, k, b, w, bias):
    build, lib = _lib()
    c, nn_, r, din = yp.shape
    dout = w.shape[-1]
    y = torch.empty((c, nn_, r, dout), dtype=torch.float32, device=yp.device)
    with torch.cuda.device(yp.device):
        code = lib.fpsg_fused_out_fwd(
            _DTYPES[yp.dtype], yp.data_ptr(), k.data_ptr(), b.data_ptr(),
            w.data_ptr(), bias.data_ptr(), y.data_ptr(), c * nn_, r, din,
            dout, _stream())
    build.check(lib, code, "fpsg_fused_out_fwd")
    count_launch(OUT)
    return y


def fused_out_layer(yp, k, b, w, bias):
    """``tanh(relu(k * yp + b) @ w + bias)``: the node_conv4 output layer.

    Args:
      yp, k, b: as :func:`fused_mid_layer`.
      w: (C, Nn, Din, Dout) in yp's dtype, Dout <= 8.
      bias: (C, Nn, Dout) f32.
    Returns: (C, Nn, R, Dout) f32.
    """
    _check_common("fused_out_layer", yp, w, k, b)
    c, nn_, _, _ = yp.shape
    dout = w.shape[-1]
    if dout > MAX_OUT_DOUT:
        raise ValueError(f"fused_out_layer: Dout {dout} > {MAX_OUT_DOUT}")
    if bias.shape != (c, nn_, dout) or bias.dtype != torch.float32:
        raise ValueError(f"fused_out_layer: bias must be f32 {(c, nn_, dout)}")
    if on_card(yp, k, b, w, bias):
        return fused_out_kernel(yp.contiguous(), k.contiguous(),
                                b.contiguous(), w.contiguous(),
                                bias.contiguous())
    return fused_out_plain(yp, k, b, w, bias)
