"""The single-read statistics kernels' plain versions against the JAX
package's Pallas kernels (interpret mode), on the CPU.

- K3, ``fpsg_torch/ops/moments.py`` vs ``fpsg_tpu.ops.moments.
  _moments_fwd_pallas`` / ``_moments_bwd_pallas``: quantized inputs make
  many exact ties for the max and min, inside and across the JAX kernel's
  512-row tiles. max/min values and first indices equal; the shifted sums
  within 1e-6 of their scale (summed in another order: measured 3.2e-7);
  the backward within 1e-6 of its scale in f32 (measured 3.2e-8) and
  within one bf16 unit (2^-8 of the value) in bf16, where the two round
  the same f32 sum once (measured: equal).
- K4, ``fpsg_torch/ops/pool_moments.py`` vs ``fpsg_tpu.ops.pool_moments.
  _fwd_pallas`` / ``_bwd_pallas`` on the same packed ``(B, H, W/2, 2C)``
  layout (the JAX statistics come per width phase and are folded here, as
  ``vgg.py:321-324`` does): values and int8 codes equal, sums and the
  backward as for K3 (measured: sums 1.6e-7, backward 5.9e-8 in f32 and
  equal in bf16).
- Each op as a whole (``moments_minmax``, ``pool_moments``: the autograd
  ``Function``) against ``jax.grad`` of the JAX op, whose gradient runs
  the Pallas backward: one loss of all four outputs, rtol 1e-5 (f32).

The CUDA kernels themselves run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpsg_torch.ops.moments import moments_bwd, moments_fwd, moments_minmax
from fpsg_torch.ops.pool_moments import (
    pool_moments, pool_moments_bwd, pool_moments_fwd,
)
from fpsg_tpu.ops import moments as jmoments
from fpsg_tpu.ops import pool_moments as jpool

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _quantized(rng, shape):
    """Values on a 0.5 grid: many exact ties for every max and min."""
    return (np.round(rng.standard_normal(shape) * 2) / 2).astype(np.float32)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def _bf16_close(got, ref):
    """Within one bf16 unit of the value (2^-8 relative), or 1e-6 of the
    scale near 0."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    bound = 2.0 ** -8 * np.maximum(np.abs(got), np.abs(ref)) \
        + 1e-6 * np.abs(ref).max()
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_moments_matches_pallas_with_ties(rng, dt):
    tdt, jdt = DTYPES[dt]
    b, n, f = 2, 1024, 128                  # two 512-row tiles in JAX
    y = _quantized(rng, (b, n, f))
    s = (0.1 * rng.standard_normal(f)).astype(np.float32)
    ref = jmoments._moments_fwd_pallas(jnp.asarray(y, jdt), jnp.asarray(s),
                                       True)
    got = moments_fwd(_t(y, tdt), _t(s))
    for k in (0, 1):
        _close(got[k].numpy(), ref[k], 1e-6)
    for k in (2, 3, 4, 5):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert got[3].dtype == torch.int32 and got[2].dtype == torch.float32
    # ties, some across the tiles: the first of equal maxima wins
    hit = y.astype(np.float32) == np.asarray(ref[2])[:, None]
    assert (hit.sum(axis=1) > 1).mean() > 0.2
    assert (hit[:, :n // 2].any(axis=1) & hit[:, n // 2:].any(axis=1)).any()
    np.testing.assert_array_equal(got[3].numpy(), hit.argmax(axis=1))

    gzs, gzq = (rng.standard_normal((2, f)) * 0.1).astype(np.float32)
    gmax, gmin = rng.standard_normal((2, b, f)).astype(np.float32)
    ref_gy = jmoments._moments_bwd_pallas(
        jnp.asarray(y, jdt), jnp.asarray(s), jnp.asarray(gzs),
        jnp.asarray(gzq), jnp.asarray(gmax), ref[3], jnp.asarray(gmin),
        ref[5], True)
    gy = moments_bwd(_t(y, tdt), _t(s), _t(gzs), _t(gzq), _t(gmax), got[3],
                     _t(gmin), got[5])
    assert gy.dtype == tdt
    if dt == "f32":
        _close(gy.numpy(), ref_gy, 1e-6)
    else:
        _bf16_close(gy.float().numpy(), ref_gy)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_pool_moments_matches_pallas_with_ties(rng, dt):
    tdt, jdt = DTYPES[dt]
    b, h, w2, c = 2, 14, 7, 128             # odd H/2 and W/2 (a VGG shape)
    y = _quantized(rng, (b, h, w2, 2 * c))
    s = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = jpool._fwd_pallas(jnp.asarray(y, jdt), jnp.tile(jnp.asarray(s), 2),
                            True)
    got = pool_moments_fwd(_t(y, tdt), _t(s))
    for k in (0, 1):
        folded = np.asarray(ref[k])[:c] + np.asarray(ref[k])[c:]
        _close(got[k].numpy(), folded, 1e-6)
    for k in (2, 3, 4, 5):
        np.testing.assert_array_equal(np.asarray(got[k].float()),
                                      np.asarray(ref[k], np.float32))
    assert got[2].dtype == tdt and got[3].dtype == torch.int8
    win = y.reshape(b, h // 2, 2, w2, 2, c)
    ties = (win == np.asarray(ref[2], np.float32)[:, :, None, :, None]
            ).sum(axis=(2, 4)) > 1
    assert ties.mean() > 0.1                           # many tied windows

    gzs, gzq = (rng.standard_normal((2, c)) * 0.1).astype(np.float32)
    gmax, gmin = rng.standard_normal((2, b, h // 2, w2, c)).astype(
        np.float32)
    ref_gy = jpool._bwd_pallas(
        jnp.asarray(y, jdt), jnp.tile(jnp.asarray(s), 2),
        jnp.tile(jnp.asarray(gzs), 2), jnp.tile(jnp.asarray(gzq), 2),
        jnp.asarray(gmax, jdt), ref[3], jnp.asarray(gmin, jdt), ref[5],
        True)
    gy = pool_moments_bwd(_t(y, tdt), _t(s), _t(gzs), _t(gzq),
                          _t(gmax, tdt), got[3], _t(gmin, tdt), got[5])
    assert gy.shape == y.shape and gy.dtype == tdt
    if dt == "f32":
        _close(gy.numpy(), ref_gy, 1e-6)
    else:
        _bf16_close(gy.float().numpy(), ref_gy)


def _loss_weights(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("op", ["moments", "pool_moments"])
def test_op_gradient_matches_jax(rng, op):
    """The autograd ``Function`` against ``jax.grad`` of the JAX op (its
    custom VJP runs the Pallas backward), ties included."""
    if op == "moments":
        y = _quantized(rng, (2, 512, 128))
        s = (0.1 * rng.standard_normal(128)).astype(np.float32)
        js, ts = jnp.asarray(s), _t(s)
        wz, wq, wx, wn = _loss_weights(rng, 128, 128, (2, 128), (2, 128))
        jop, top = jmoments.moments_minmax, moments_minmax
        wz2, wq2 = wz, wq
    else:
        y = _quantized(rng, (2, 8, 6, 256))
        s = (0.1 * rng.standard_normal(128)).astype(np.float32)
        js, ts = jnp.tile(jnp.asarray(s), 2), _t(s)
        wz, wq, wx, wn = _loss_weights(rng, 128, 128, (2, 4, 6, 128),
                                       (2, 4, 6, 128))
        jop, top = jpool.pool_moments, pool_moments
        wz2, wq2 = np.tile(wz, 2), np.tile(wq, 2)    # per packed channel

    def jloss(yy):
        zs, zq, ymax, ymin = jop(yy, js)
        return (jnp.sum(zs * wz2) + jnp.sum(zq * wq2) * 0.01
                + jnp.sum(ymax * wx) + jnp.sum(ymin * wn))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(y)))
    ty = _t(y).requires_grad_()
    zs, zq, ymax, ymin = top(ty, ts)
    loss = ((zs * _t(wz)).sum() + (zq * _t(wq)).sum() * 0.01
            + (ymax * _t(wx)).sum() + (ymin * _t(wn)).sum())
    loss.backward()
    np.testing.assert_allclose(ty.grad.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        moments_fwd(torch.zeros(2, 4, 8), torch.zeros(4))
    with pytest.raises(TypeError):
        moments_fwd(torch.zeros(2, 4, 8, dtype=torch.float64),
                    torch.zeros(8))
    with pytest.raises(ValueError):
        pool_moments_fwd(torch.zeros(1, 3, 2, 8), torch.zeros(4))
    with pytest.raises(ValueError):
        pool_moments_fwd(torch.zeros(1, 2, 2, 8), torch.zeros(8))
