"""Fused layers of the stacked primitive-node MLP chain
(counterpart of ``fpsg_tpu/nn/fused_stack.py``), forward with and without
the fused output statistics, and backward.

Layout as in the JAX package: activations group-major ``(C, Nn, R, D)``
with ``R = B * P`` rows (B clouds x P points per node), weights ``(C, Nn,
Din, Dout)``, the previous BN's collapsed affine ``k``/``b`` as ``(C, Nn,
D)`` f32. Each layer reads its input once and writes its output once:

- ``fused_l1_layer``: ``y = d @ Wd + y_cond[row // P]``. Replaces
  ``_fused_l1_fwd`` (``fused_stack.py:525-551``). K = raw_dim = 3, so it is
  bound by the bytes of y it writes. The conditioning is added in f32 and
  y rounds once to the activation dtype. ``with_stats`` also returns, per
  channel, ``zsum``, ``zsq`` and ``zcov = sum z * sc[cloud]`` of ``z =
  round(y) - y_cond[cloud]``: the exact two-pass variance of node_bn1 in
  one read (``fused_stack.py:36-55``).
- ``fused_mid_layer``: ``y = relu(k * yp + b) @ W`` per (cluster, node),
  f32 accumulation, one rounding. Replaces ``_fused_mid_fwd``
  (``:308-332``). A batched GEMM of C*Nn groups with the BN affine and relu
  applied as the A tile is loaded; bound by operations. ``with_stats``
  also returns ``zsum``, ``zsq`` of ``z = round(y) - s`` for the
  single-read shift ``s``.
- ``fused_out_layer``: ``tanh(relu(k * yp + b) @ W + bias)``, f32 out.
  Replaces ``_fused_out_fwd`` (``:676-693``). N = raw_dim = 3, so it is
  bound by the bytes of yp it reads.

The backward kernels (``_fused_*_bwd_impl``, ``:337-383``, ``:554-597``,
``:696-726``):

- mid layers, two kernels: K5b (``mid_dx``) ``dyp = (relu'(pre) *
  (g @ W^T)) * k`` with per-channel ``dk = sum dm * yp``, ``db = sum dm``;
  K5c (``mid_dw``) ``dW = relu(k * yp + b)^T @ g`` with A recomputed. With
  statistics, ``g = round(gy + gzs + 2 z gzq)`` folds the statistics'
  cotangents in.
- layer 1, K5e (``l1_bwd``): ``gt = gy + gzs + 2 z gzq + sc gzc`` (the z
  path), ``dd = gt @ Wd^T``, ``dWd = d^T @ gt``, ``dy_cond[cloud] =
  sum gy`` (the plain gy: y_cond is not part of z), ``dsc[cloud] = (sum
  z) * gzc``.
- output layer, K5g (``out_bwd``): ``gt = gy (1 - y^2)`` from the f32
  tanh output, ``dyp``, ``dk``, ``db`` as K5b, ``dW = relu(pre)^T @ gt``,
  ``dbias = sum gt``.

Roundings as the TPU kernels: the affine runs in the activation dtype
(``k``/``b`` cast to it, one rounding after the multiply and one after the
add); the relu mask is ``pre > 0`` (strict) in f32; every cotangent is
formed in f32 and rounded to the activation dtype once before it enters a
product; products accumulate in f32; ``dW`` is summed in f32 and rounded
to the weight's dtype once.

:func:`fused_l1_layer`, :func:`fused_mid_layer` and :func:`fused_out_layer`
are ``torch.autograd.Function`` s. A CUDA tensor launches the kernels of
``csrc/fused_stack.cu`` (CUDA C++, sm_90a); a CPU tensor runs the plain
versions below, forward and backward (hand-written, not autograd through
the plain forward). The statistics' shift ``s`` gets no gradient (it is
``stop_gradient`` in the JAX package); a missing cotangent is zero.

Not ported: the 3 -> 8 lane padding of raw_dim (``decoder.py:353,362-365,
423-424``) and the Mosaic row tiles (``_row_tile``, ``_dw_tiles``) are TPU
layout constraints.
"""

from __future__ import annotations

import ctypes

import torch

from fpsg_torch.ops import count_launch, on_card, register_kernel

L1, MID, OUT = "fused_l1", "fused_mid", "fused_out"
L1_STATS, MID_STATS = "fused_l1_stats", "fused_mid_stats"
MID_DX, MID_DW, L1_BWD, OUT_BWD = ("fused_mid_dx", "fused_mid_dw",
                                   "fused_l1_bwd", "fused_out_bwd")
for _name in (L1, MID, OUT, L1_STATS, MID_STATS, MID_DX, MID_DW, L1_BWD,
              OUT_BWD):
    register_kernel(_name)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fpsg_fused_l1_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fpsg_fused_l1_fwd_stats": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _P],
    "fpsg_fused_mid_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fpsg_fused_mid_fwd_stats": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _P],
    "fpsg_fused_mid_dx": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _I, _I, _I, _I, _P],
    "fpsg_fused_mid_dw": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _P],
    "fpsg_fused_out_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fpsg_fused_out_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _P],
    "fpsg_fused_l1_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
MAX_L1_DIN = 8     # csrc/fused_stack.cu: L1 point width held in registers
MAX_OUT_DOUT = 8   # csrc/fused_stack.cu: output width held in registers
# csrc/fused_stack.cu's row blocks, which size the per-block partial sums
TILE = 128          # GEMM tile rows (K5a, K5b)
L1_STAT_ROWS = 128  # K5d with statistics
OUTB_ROWS = 64      # K5g
L1B_COLS = 256      # K5e column chunk


def _lib():
    from fpsg_torch.ops import _build

    return _build, _build.load("fused_stack", _SIGNATURES)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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


def _check_chan(name, shape, *vs):
    for v in vs:
        if v.shape != shape or v.dtype != torch.float32:
            raise ValueError(f"{name}: per-channel vectors must be f32 "
                             f"{shape}, got {v.dtype} {tuple(v.shape)}")


def _pre(yp, k, b):
    """``k * yp + b`` in yp's dtype (k, b rounded to it; one rounding after
    the multiply, one after the add)."""
    dt = yp.dtype
    return yp * k.to(dt)[:, :, None, :] + b.to(dt)[:, :, None, :]


def _affine_relu(yp, k, b):
    """relu(k * yp + b) in yp's dtype, per (cluster, node, channel)."""
    return torch.relu(_pre(yp, k, b))


def _chan(v):
    return v[:, :, None, :]


def _adjusted(gy, y, s, gzs, gzq):
    """The mid layers' cotangent of y with the statistics' cotangents
    folded in, ``gy + gzs + 2 (y - s) gzq`` in f32 (``gy`` alone without
    statistics)."""
    g = gy.float()
    if s is None:
        return g
    z = y.float() - _chan(s)
    return g + _chan(gzs) + 2.0 * z * _chan(gzq)


def _t(x):
    return x.transpose(-1, -2)


def _ptrs(*ts):
    """Device pointers for a kernel's arguments (None: a null pointer)."""
    return [t.data_ptr() if t is not None else None for t in ts]


# --- layer 1 ---------------------------------------------------------------

def fused_l1_plain(d, wd, y_cond, p: int, sc=None):
    """Plain PyTorch version of the layer-1 forward: y, and with ``sc``
    also ``(zsum, zsq, zcov)``."""
    yc = y_cond.float().repeat_interleave(p, dim=2)
    y = (torch.matmul(d.float(), wd.float()) + yc).to(d.dtype)
    if sc is None:
        return y
    z = y.float() - yc
    return (y, z.sum(2), (z * z).sum(2),
            (z * sc.float().repeat_interleave(p, dim=2)).sum(2))


def fused_l1_kernel(d, wd, y_cond, p: int, sc=None):
    build, lib = _lib()
    c, nn_, r, din = d.shape
    dout = wd.shape[-1]
    y = torch.empty((c, nn_, r, dout), dtype=d.dtype, device=d.device)
    if sc is None:
        with torch.cuda.device(d.device):
            code = lib.fpsg_fused_l1_fwd(
                _DTYPES[d.dtype], d.data_ptr(), wd.data_ptr(),
                y_cond.data_ptr(), y.data_ptr(), c * nn_, r, p, din, dout,
                _stream())
        build.check(lib, code, "fpsg_fused_l1_fwd")
        count_launch(L1)
        return y
    stats = torch.empty((3, c, nn_, dout), dtype=torch.float32,
                        device=d.device)
    part = torch.empty(3 * c * nn_ * _cdiv(r, L1_STAT_ROWS) * dout,
                       dtype=torch.float32, device=d.device)
    with torch.cuda.device(d.device):
        code = lib.fpsg_fused_l1_fwd_stats(
            _DTYPES[d.dtype], d.data_ptr(), wd.data_ptr(), y_cond.data_ptr(),
            sc.data_ptr(), y.data_ptr(), part.data_ptr(), stats.data_ptr(),
            c * nn_, r, p, din, dout, _stream())
    build.check(lib, code, "fpsg_fused_l1_fwd_stats")
    count_launch(L1_STATS)
    return (y, *stats.unbind(0))


def fused_l1_bwd_plain(d, wd, y_cond, sc, y, gy, gzs, gzq, gzc, p: int):
    """Plain PyTorch version of K5e: ``(dd, dwd, dy_cond, dsc)`` in the
    dtypes of ``d``, ``wd``, f32, f32 (``dsc`` None without statistics,
    ``sc`` None)."""
    c, nn_, r, _ = d.shape
    dt = d.dtype
    gyf = gy.float()
    gt = gyf
    dsc = None
    if sc is not None:
        yc = y_cond.float().repeat_interleave(p, dim=2)
        z = y.float() - yc
        gt = gyf + (_chan(gzs) + 2.0 * z * _chan(gzq)
                    + sc.float().repeat_interleave(p, dim=2) * _chan(gzc))
        dsc = z.reshape(c, nn_, r // p, p, -1).sum(3) * _chan(gzc)
    gtd = gt.to(dt).float()
    dd = torch.matmul(gtd, _t(wd.float())).to(dt)
    dwd = torch.matmul(_t(d.float()), gtd).to(wd.dtype)
    dyc = gyf.reshape(c, nn_, r // p, p, -1).sum(3)
    return dd, dwd, dyc, dsc


def fused_l1_bwd_kernel(d, wd, y_cond, sc, y, gy, gzs, gzq, gzc, p: int):
    build, lib = _lib()
    c, nn_, r, din = d.shape
    dout = wd.shape[-1]
    g, nb = c * nn_, r // p
    stats = sc is not None
    dev = d.device
    dd = torch.empty_like(d)
    dwd = torch.empty_like(wd)
    dyc = torch.empty((c, nn_, nb, dout), dtype=torch.float32, device=dev)
    dsc = torch.empty_like(dyc) if stats else None
    part = torch.empty(g * _cdiv(dout, L1B_COLS) * r * din
                       + g * nb * din * dout, dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        code = lib.fpsg_fused_l1_bwd(
            _DTYPES[d.dtype], int(stats),
            *_ptrs(d, wd, y_cond, sc, y, gy, gzs, gzq, gzc, dd, dwd, dyc,
                   dsc, part), g, r, p, din, dout, _stream())
    build.check(lib, code, "fpsg_fused_l1_bwd")
    count_launch(L1_BWD)
    return dd, dwd, dyc, dsc


class _L1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, wd, y_cond, sc, p):
        yc = y_cond.float().contiguous()
        if on_card(d, wd, yc, *([sc] if sc is not None else [])):
            out = fused_l1_kernel(d, wd, yc, p, sc)
        else:
            out = fused_l1_plain(d, wd, yc, p, sc)
        y = out if sc is None else out[0]
        ctx.p, ctx.yc_dtype = p, y_cond.dtype
        ctx.save_for_backward(d, wd, yc, sc, y)
        return out

    @staticmethod
    def backward(ctx, gy, *gstats):
        d, wd, yc, sc, y = ctx.saved_tensors
        gz = [g.float().contiguous() for g in gstats] if sc is not None \
            else [None, None, None]
        args = (d, wd, yc, sc, y, gy.contiguous(), *gz, ctx.p)
        if on_card(d, gy):
            dd, dwd, dyc, dsc = fused_l1_bwd_kernel(*args)
        else:
            dd, dwd, dyc, dsc = fused_l1_bwd_plain(*args)
        return dd, dwd, dyc.to(ctx.yc_dtype), dsc, None


def fused_l1_layer(d, wd, y_cond, p: int, sc=None, with_stats: bool = False):
    """``d @ wd + y_cond`` per cloud, with the statistics on request.

    Args:
      d: (C, Nn, R, Din) deformed template points, R = B * p, Din <= 8.
      wd: (C, Nn, Din, Dout) point rows of the node_conv1 kernel, d's dtype.
      y_cond: (C, Nn, B, Dout) hoisted conditioning matmul output (f32 or
        d's dtype; added in f32).
      p: points per cloud.
      sc: (C, Nn, B, Dout) f32, y_cond centred by its mean over B
        (``with_stats`` only).
      with_stats: also return ``zsum``, ``zsq``, ``zcov`` (C, Nn, Dout)
        f32 of ``z = y - y_cond`` per row.
    Returns: y (C, Nn, R, Dout) in d's dtype, or ``(y, zsum, zsq, zcov)``.
    """
    _check_common("fused_l1_layer", d, wd)
    c, nn_, r, din = d.shape
    dout = wd.shape[-1]
    if r % p or y_cond.shape != (c, nn_, r // p, dout) \
            or y_cond.dtype not in (torch.float32, d.dtype):
        raise ValueError(f"fused_l1_layer: y_cond {y_cond.dtype} "
                         f"{tuple(y_cond.shape)} for R={r}, p={p}")
    if din > MAX_L1_DIN:
        raise ValueError(f"fused_l1_layer: Din {din} > {MAX_L1_DIN}")
    if with_stats:
        _check_chan("fused_l1_layer", y_cond.shape, sc)
        sc = sc.contiguous()
    else:
        sc = None
    return _L1.apply(d.contiguous(), wd.contiguous(), y_cond, sc, p)


# --- mid layers ------------------------------------------------------------

def fused_mid_plain(yp, k, b, w, s=None):
    """Plain PyTorch version of the mid-layer forward: y, and with ``s``
    also ``(zsum, zsq)``."""
    a = _affine_relu(yp, k, b)
    y = torch.matmul(a.float(), w.float()).to(yp.dtype)
    if s is None:
        return y
    z = y.float() - _chan(s)
    return y, z.sum(2), (z * z).sum(2)


def fused_mid_kernel(yp, k, b, w, s=None):
    build, lib = _lib()
    c, nn_, r, din = yp.shape
    dout = w.shape[-1]
    y = torch.empty((c, nn_, r, dout), dtype=yp.dtype, device=yp.device)
    if s is None:
        with torch.cuda.device(yp.device):
            code = lib.fpsg_fused_mid_fwd(
                _DTYPES[yp.dtype], yp.data_ptr(), k.data_ptr(), b.data_ptr(),
                w.data_ptr(), y.data_ptr(), c * nn_, r, din, dout, _stream())
        build.check(lib, code, "fpsg_fused_mid_fwd")
        count_launch(MID)
        return y
    stats = torch.empty((2, c, nn_, dout), dtype=torch.float32,
                        device=yp.device)
    part = torch.empty(2 * c * nn_ * _cdiv(r, TILE) * dout,
                       dtype=torch.float32, device=yp.device)
    with torch.cuda.device(yp.device):
        code = lib.fpsg_fused_mid_fwd_stats(
            _DTYPES[yp.dtype], yp.data_ptr(), k.data_ptr(), b.data_ptr(),
            w.data_ptr(), s.data_ptr(), y.data_ptr(), part.data_ptr(),
            stats.data_ptr(), c * nn_, r, din, dout, _stream())
    build.check(lib, code, "fpsg_fused_mid_fwd_stats")
    count_launch(MID_STATS)
    return (y, *stats.unbind(0))


def fused_mid_dx_plain(yp, k, b, w, s, y, gy, gzs, gzq):
    """Plain PyTorch version of K5b: ``(dyp, dk, db)``."""
    dt = yp.dtype
    g = _adjusted(gy, y, s, gzs, gzq).to(dt)
    da = torch.matmul(g.float(), _t(w.float()))
    dm = torch.where(_pre(yp, k, b).float() > 0, da, 0.0)
    dyp = (dm * _chan(k)).to(dt)
    return dyp, (dm * yp.float()).sum(2), dm.sum(2)


def fused_mid_dw_plain(yp, k, b, s, y, gy, gzs, gzq, w_dtype):
    """Plain PyTorch version of K5c: dW in ``w_dtype``."""
    g = _adjusted(gy, y, s, gzs, gzq).to(yp.dtype)
    a = _affine_relu(yp, k, b)
    return torch.matmul(_t(a.float()), g.float()).to(w_dtype)



def fused_mid_dx_kernel(yp, k, b, w, s, y, gy, gzs, gzq):
    build, lib = _lib()
    c, nn_, r, din = yp.shape
    dout = w.shape[-1]
    dyp = torch.empty_like(yp)
    dkdb = torch.empty((2, c, nn_, din), dtype=torch.float32,
                       device=yp.device)
    part = torch.empty(2 * c * nn_ * _cdiv(r, TILE) * din,
                       dtype=torch.float32, device=yp.device)
    with torch.cuda.device(yp.device):
        code = lib.fpsg_fused_mid_dx(
            _DTYPES[yp.dtype], int(s is not None),
            *_ptrs(yp, k, b, w, s, y, gy, gzs, gzq, dyp, part, dkdb),
            c * nn_, r, din, dout, _stream())
    build.check(lib, code, "fpsg_fused_mid_dx")
    count_launch(MID_DX)
    return (dyp, *dkdb.unbind(0))


def fused_mid_dw_kernel(yp, k, b, s, y, gy, gzs, gzq, w_dtype):
    build, lib = _lib()
    c, nn_, r, din = yp.shape
    dout = gy.shape[-1]
    if w_dtype != yp.dtype:
        raise TypeError(f"fused_mid_dw: dW dtype {w_dtype} != {yp.dtype}")
    dw = torch.empty((c, nn_, din, dout), dtype=w_dtype, device=yp.device)
    with torch.cuda.device(yp.device):
        code = lib.fpsg_fused_mid_dw(
            _DTYPES[yp.dtype], int(s is not None),
            *_ptrs(yp, k, b, s, y, gy, gzs, gzq, dw),
            c * nn_, r, din, dout, _stream())
    build.check(lib, code, "fpsg_fused_mid_dw")
    count_launch(MID_DW)
    return dw


class _Mid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, yp, k, b, w, s):
        ctx.card = on_card(yp, k, b, w, *([s] if s is not None else []))
        out = (fused_mid_kernel if ctx.card else fused_mid_plain)(
            yp, k, b, w, s)
        ctx.save_for_backward(yp, k, b, w, s,
                              out if s is None else out[0])
        return out

    @staticmethod
    def backward(ctx, gy, *gstats):
        yp, k, b, w, s, y = ctx.saved_tensors
        gzs, gzq = ([g.float().contiguous() for g in gstats]
                    if s is not None else (None, None))
        gy = gy.contiguous()
        if ctx.card:
            dyp, dk, db = fused_mid_dx_kernel(yp, k, b, w, s, y, gy, gzs, gzq)
            dw = fused_mid_dw_kernel(yp, k, b, s, y, gy, gzs, gzq, w.dtype)
        else:
            dyp, dk, db = fused_mid_dx_plain(yp, k, b, w, s, y, gy, gzs, gzq)
            dw = fused_mid_dw_plain(yp, k, b, s, y, gy, gzs, gzq, w.dtype)
        return dyp, dk, db, dw, None


def fused_mid_layer(yp, k, b, w, s=None, with_stats: bool = False):
    """``relu(k * yp + b) @ w`` per (cluster, node), with the statistics on
    request.

    Args:
      yp: (C, Nn, R, Din) previous layer's raw output.
      k, b: (C, Nn, Din) f32, the previous BN's collapsed affine.
      w: (C, Nn, Din, Dout) in yp's dtype.
      s: (C, Nn, Dout) f32 statistics shift (``with_stats`` only; gets no
        gradient).
      with_stats: also return ``zsum``, ``zsq`` (C, Nn, Dout) f32 of
        ``z = y - s``.
    Returns: y (C, Nn, R, Dout) in yp's dtype, or ``(y, zsum, zsq)``.
    """
    _check_common("fused_mid_layer", yp, w, k, b)
    if with_stats:
        _check_chan("fused_mid_layer", w.shape[:2] + w.shape[3:], s)
        s = s.detach().contiguous()
    else:
        s = None
    return _Mid.apply(yp.contiguous(), k.contiguous(), b.contiguous(),
                      w.contiguous(), s)


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


def fused_out_bwd_plain(yp, k, b, w, y, gy):
    """Plain PyTorch version of K5g: ``(dyp, dk, db, dw, dbias)``."""
    dt = yp.dtype
    gt = gy.float() * (1.0 - y * y)
    gtd = gt.to(dt).float()
    da = torch.matmul(gtd, _t(w.float()))
    pre = _pre(yp, k, b)
    dm = torch.where(pre.float() > 0, da, 0.0)
    dyp = (dm * _chan(k)).to(dt)
    dw = torch.matmul(_t(torch.relu(pre).float()), gtd).to(w.dtype)
    return (dyp, (dm * yp.float()).sum(2), dm.sum(2), dw, gt.sum(2))


def fused_out_bwd_kernel(yp, k, b, w, y, gy):
    build, lib = _lib()
    c, nn_, r, din = yp.shape
    dout = w.shape[-1]
    g = c * nn_
    dev = yp.device
    dyp = torch.empty_like(yp)
    dkdb = torch.empty((2, c, nn_, din), dtype=torch.float32, device=dev)
    dw = torch.empty_like(w)
    dbias = torch.empty((c, nn_, dout), dtype=torch.float32, device=dev)
    part = torch.empty(g * _cdiv(r, OUTB_ROWS) * (2 * din + din * dout
                                                  + dout),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.fpsg_fused_out_bwd(
            _DTYPES[yp.dtype],
            *_ptrs(yp, k, b, w, y, gy, dyp, part, dkdb, dw, dbias),
            g, r, din, dout, _stream())
    build.check(lib, code, "fpsg_fused_out_bwd")
    count_launch(OUT_BWD)
    return (dyp, *dkdb.unbind(0), dw, dbias)


class _Out(torch.autograd.Function):
    @staticmethod
    def forward(ctx, yp, k, b, w, bias):
        ctx.card = on_card(yp, k, b, w, bias)
        y = (fused_out_kernel if ctx.card else fused_out_plain)(
            yp, k, b, w, bias)
        ctx.save_for_backward(yp, k, b, w, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        yp, k, b, w, y = ctx.saved_tensors
        bwd = fused_out_bwd_kernel if ctx.card else fused_out_bwd_plain
        return bwd(yp, k, b, w, y, gy.float().contiguous())


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
    return _Out.apply(yp.contiguous(), k.contiguous(), b.contiguous(),
                      w.contiguous(), bias.contiguous())

