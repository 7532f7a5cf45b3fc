"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version (what a kernel wrapper runs for a CPU tensor)
is held against the TPU kernel it replaces, run here in Pallas interpret
mode, on the same numpy inputs:

- 2x2 max-pool (``fpsg_torch/ops/pool.py``) vs ``fpsg_tpu.nn.vgg.
  _pool_pallas_fwd`` on the width-packed view ``x.reshape(b, h, w//2, 2c)``:
  bitwise, values and first-match codes, with forced ties.
- fused decoder layers (``fpsg_torch/nn/fused_stack.py``) vs
  ``fpsg_tpu.nn.fused_stack.fused_{l1,mid,out}_layer`` with
  ``with_stats=False``. f32: rtol 1e-5, atol 1e-6 — the same products
  summed in another order. bf16: within 2 bf16 ulps (rtol 1e-2) of the
  output scale — the affine and the output each round to bf16, and one
  rounding may land on the other side.

The CUDA kernels themselves run only on a card: see
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpsg_torch import ops
from fpsg_torch.nn import fused_stack as tfs
from fpsg_torch.ops.pool import maxpool2x2, maxpool2x2_plain
from fpsg_tpu.nn import fused_stack as jfs
from fpsg_tpu.nn.vgg import _pool_pallas_fwd

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _to_torch(a: np.ndarray, dt: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dt)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _pool_input(rng, shape):
    """Random values with forced ties: in a quarter of the windows two or
    more elements equal the window's maximum."""
    x = rng.standard_normal(shape).astype(np.float32)
    b, h, w, c = shape
    x6 = x.reshape(b, h // 2, 2, w // 2, 2, c)
    m = x6.max(axis=(2, 4), keepdims=True)
    tie = rng.random((b, h // 2, 1, w // 2, 1, c)) < 0.25
    pick = rng.random(x6.shape) < 0.5
    x6[:] = np.where(tie & pick, m, x6)
    return x6.reshape(shape)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pool_matches_pallas_bitwise(rng, dt):
    tdt, jdt = DTYPES[dt]
    b, h, w, c = 2, 8, 12, 16
    x = _pool_input(rng, (b, h, w, c))
    xt = _to_torch(x, tdt)
    y, code = maxpool2x2(xt, return_index=True)
    ry, rcode = _pool_pallas_fwd(
        jnp.asarray(x, jdt).reshape(b, h, w // 2, 2 * c))
    np.testing.assert_array_equal(_np(y), np.asarray(ry, np.float32))
    np.testing.assert_array_equal(code.numpy(), np.asarray(rcode))
    assert (code.numpy() > 0).any() and (code.numpy() == 0).any()


def test_pool_tie_goes_to_first_maximum():
    """Every window position holds the maximum in turn; the code is the
    first position holding it, in row-major (dh, dw) order."""
    x = torch.zeros((1, 2, 2, 4))
    x[0, 1, 1, 1] = 1.0                       # only (1,1): code 3
    x[0, 0, 1, 2] = x[0, 1, 0, 2] = 1.0       # (0,1) and (1,0): code 1
    x[0, 1, 0, 3] = x[0, 1, 1, 3] = 1.0       # (1,0) and (1,1): code 2
    y, code = maxpool2x2_plain(x)             # channel 0: all equal: 0
    assert code.flatten().tolist() == [0, 3, 1, 2]
    assert y.flatten().tolist() == [0.0, 1.0, 1.0, 1.0]


def _affine(rng, c, n, d):
    k = rng.standard_normal((c, n, d)).astype(np.float32)
    k[0, 0, :4] = 0.0                         # zero scale stays exact
    b = (0.3 * rng.standard_normal((c, n, d))).astype(np.float32)
    return k, b


def _close(got, ref, dt):
    ref = np.asarray(ref, np.float32)
    if dt == "f32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-2 * scale)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_l1_matches_pallas(rng, dt):
    tdt, jdt = DTYPES[dt]
    c, n, b, p, din, dout = 2, 2, 2, 16, 3, 67
    d = rng.uniform(-1, 1, (c, n, b * p, din)).astype(np.float32)
    wd = (rng.standard_normal((c, n, din, dout)) / 2).astype(np.float32)
    yc = rng.standard_normal((c, n, b, dout)).astype(np.float32)
    got = tfs.fused_l1_layer(_to_torch(d, tdt), _to_torch(wd, tdt),
                             torch.from_numpy(yc), p)
    assert got.dtype == tdt and got.shape == (c, n, b * p, dout)
    pad = ((0, 0),) * 3 + ((0, 8 - din),)
    dpad = np.pad(d, pad)
    wpad = np.pad(wd, ((0, 0), (0, 0), (0, 8 - din), (0, 0)))
    ref = jfs.fused_l1_layer(jnp.asarray(dpad, jdt), jnp.asarray(wpad, jdt),
                             jnp.asarray(yc), jnp.zeros_like(yc), False, p)[0]
    _close(_np(got), ref, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_mid_matches_pallas(rng, dt):
    tdt, jdt = DTYPES[dt]
    c, n, r, din, dout = 2, 2, 32, 67, 33
    yp = rng.standard_normal((c, n, r, din)).astype(np.float32)
    k, b = _affine(rng, c, n, din)
    w = (rng.standard_normal((c, n, din, dout)) / np.sqrt(din)).astype(
        np.float32)
    got = tfs.fused_mid_layer(_to_torch(yp, tdt), torch.from_numpy(k),
                              torch.from_numpy(b), _to_torch(w, tdt))
    assert got.dtype == tdt and got.shape == (c, n, r, dout)
    ref = jfs.fused_mid_layer(jnp.asarray(yp, jdt), jnp.asarray(k),
                              jnp.asarray(b), jnp.asarray(w, jdt),
                              jnp.zeros((c, n, dout)), False, 16)[0]
    _close(_np(got), ref, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_out_matches_pallas(rng, dt):
    tdt, jdt = DTYPES[dt]
    c, n, r, din, dout = 2, 2, 32, 33, 3
    yp = rng.standard_normal((c, n, r, din)).astype(np.float32)
    k, b = _affine(rng, c, n, din)
    w = (rng.standard_normal((c, n, din, dout)) / np.sqrt(din)).astype(
        np.float32)
    bias = (0.1 * rng.standard_normal((c, n, dout))).astype(np.float32)
    got = tfs.fused_out_layer(_to_torch(yp, tdt), torch.from_numpy(k),
                              torch.from_numpy(b), _to_torch(w, tdt),
                              torch.from_numpy(bias))
    assert got.dtype == torch.float32 and got.shape == (c, n, r, dout)
    wpad = np.pad(w, ((0, 0), (0, 0), (0, 0), (0, 8 - dout)))
    bpad = np.pad(bias, ((0, 0), (0, 0), (0, 8 - dout)))
    ref = jfs.fused_out_layer(jnp.asarray(yp, jdt), jnp.asarray(k),
                              jnp.asarray(b), jnp.asarray(wpad, jdt),
                              jnp.asarray(bpad), 16)[..., :dout]
    _close(got.numpy(), ref, dt)


def test_cpu_tensors_take_the_plain_path(rng):
    """A CPU tensor never reaches a kernel: no launch is counted, and the
    result is the plain version's, bit for bit."""
    ops.reset_launch_counts()
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 8)).astype(np.float32))
    y = maxpool2x2(x)
    assert torch.equal(y, maxpool2x2_plain(x)[0])
    yp = torch.randn(1, 1, 8, 5)
    k, b, w = torch.rand(1, 1, 5), torch.zeros(1, 1, 5), torch.randn(1, 1, 5, 3)
    assert torch.equal(tfs.fused_mid_layer(yp, k, b, w),
                       tfs.fused_mid_plain(yp, k, b, w))
    assert set(ops.launch_counts()) >= {
        "maxpool2x2", "fused_l1", "fused_mid", "fused_out"}
    assert not any(ops.launch_counts().values())


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="even H, W"):
        maxpool2x2(torch.zeros(1, 3, 4, 2))
    with pytest.raises(TypeError, match="not supported"):
        maxpool2x2(torch.zeros(1, 2, 2, 2, dtype=torch.float64))
    yp = torch.zeros(1, 1, 4, 5)
    with pytest.raises(ValueError, match="affine"):
        tfs.fused_mid_layer(yp, torch.zeros(1, 1, 4), torch.zeros(1, 1, 5),
                            torch.zeros(1, 1, 5, 2))
    with pytest.raises(ValueError, match="Dout"):
        tfs.fused_out_layer(yp, torch.zeros(1, 1, 5), torch.zeros(1, 1, 5),
                            torch.zeros(1, 1, 5, 9), torch.zeros(1, 1, 9))
