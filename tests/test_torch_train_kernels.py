"""The training slice's kernel modules against the JAX package, on the CPU.

Each plain PyTorch version (what a kernel wrapper runs for a CPU tensor)
is held against the TPU kernel it replaces, run in Pallas interpret mode,
on the same numpy inputs:

- Chamfer nearest neighbour (``fpsg_torch/ops/chamfer.py:nn_both``) vs
  ``fpsg_tpu.ops.chamfer._nn_pallas_both``: indices equal, distances
  within 1e-6 of the distance scale (the JAX kernel forms the cross term
  as one f32 matmul, the port coordinate by coordinate: the last bit can
  differ). Duplicate points force exact ties, which both send to the
  first index.
- segment sum (``fpsg_torch/ops/scatter.py``) vs ``fpsg_tpu.ops.scatter.
  _segment_sum_pallas``: within 1e-6 relative (the mask kernel sums each
  column in another order).
- 2x2 max-pool backward (``fpsg_torch/ops/pool.py:maxpool2x2_bwd``) vs
  ``fpsg_tpu.nn.vgg._pool_pallas_bwd`` on the width-packed view: bitwise.
- Chamfer gradients of the port's autograd ``Function`` vs ``jax.grad`` of
  ``chamfer_distance(impl="pallas")``: rtol 1e-5 (the same index-routed
  formula; the pushes sum in other orders).

The CUDA kernels themselves run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpsg_torch.ops.chamfer import chamfer_distance, nn_both
from fpsg_torch.ops.pairwise import pairwise_sqdist
from fpsg_torch.ops.pool import maxpool2x2, maxpool2x2_bwd, pool2x2
from fpsg_torch.ops.scatter import segment_sum
from fpsg_tpu.nn.vgg import _pool_pallas_bwd, _pool_pallas_fwd
from fpsg_tpu.ops.chamfer import _nn_pallas_both
from fpsg_tpu.ops.chamfer import chamfer_distance as jax_chamfer
from fpsg_tpu.ops.scatter import _segment_sum_pallas


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _clouds(rng, b, n, m):
    """Two clouds with exact ties: y repeats points, and some x are
    equidistant from two distinct y."""
    x = (0.5 * rng.standard_normal((b, n, 3))).astype(np.float32)
    y = (0.5 * rng.standard_normal((b, m, 3))).astype(np.float32)
    y[:, 10:20] = y[:, 0:10]              # duplicates: ties of d == d
    x[:, 30:40] = x[:, 0:10]              # and in the other direction
    return x, y


def test_nn_both_matches_pallas_with_ties(rng):
    x, y = _clouds(rng, 2, 256, 256)
    got = nn_both(torch.from_numpy(x), torch.from_numpy(y))
    ref = _nn_pallas_both(jnp.asarray(x), jnp.asarray(y), tile_n=128,
                          interpret=True)
    scale = float(np.asarray(ref[0]).max())
    for k in (0, 2):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-6 * scale)
    for k in (1, 3):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    # the duplicated y points never win over their first copies
    assert not ((got[1] >= 10) & (got[1] < 20)).any()
    assert not ((got[3] >= 30) & (got[3] < 40)).any()


def test_nn_both_is_one_matrix_reduced_two_ways(rng):
    """Both directions reduce the same matrix, first index on ties."""
    x, y = _clouds(rng, 2, 64, 48)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    d = pairwise_sqdist(tx, ty)
    dxy, ixy, dyx, iyx = nn_both(tx, ty)
    for dmin, arg, dim in ((dxy, ixy, 2), (dyx, iyx, 1)):
        assert torch.equal(dmin, d.amin(dim=dim))
        hits = (d == dmin.unsqueeze(dim)).int()
        first = torch.argmax(hits, dim=dim)       # first True along dim
        assert torch.equal(arg.long(), first)


def test_pairwise_sqdist_expansion(rng):
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    y = rng.standard_normal((2, 7, 3)).astype(np.float32)
    ref = ((x[:, :, None, :].astype(np.float64)
            - y[:, None, :, :]) ** 2).sum(-1)
    got = pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert (pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(x))
            .diagonal(dim1=1, dim2=2) >= 0).all()


def test_segment_sum_matches_pallas(rng):
    b, n, size, d = 2, 256, 128, 3
    vals = rng.standard_normal((b, n, d)).astype(np.float32)
    idx = rng.integers(0, size // 2, (b, n)).astype(np.int32)  # collisions,
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(idx), size)
    ref = _segment_sum_pallas(jnp.asarray(vals), jnp.asarray(idx), size,
                              128, True)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    assert (got[:, size // 2:] == 0).all()                 # empty segments


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pool_bwd_matches_pallas_bitwise(rng, dt):
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dt]
    b, h, w, c = 2, 8, 12, 16
    x = np.round(rng.standard_normal((b, h, w, c)) * 2) / 2   # ties
    xj = jnp.asarray(x, jdt).reshape(b, h, w // 2, 2 * c)
    _, jcode = _pool_pallas_fwd(xj)
    g = rng.standard_normal((b, h // 2, w // 2, c)).astype(np.float32)
    ref = _pool_pallas_bwd(jcode, jnp.asarray(g, jdt))
    _, code = maxpool2x2(torch.from_numpy(x.astype(np.float32)).to(tdt),
                         return_index=True)
    assert np.array_equal(code.numpy(), np.asarray(jcode))
    got = maxpool2x2_bwd(torch.from_numpy(g).to(tdt), code)
    assert got.shape == (b, h, w, c)
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(ref, np.float32).reshape(b, h, w, c))


def test_pool2x2_gradient_routes_to_first_maximum():
    x = torch.zeros((1, 2, 2, 3), requires_grad=True)
    with torch.no_grad():
        x[0, 1, 1, 1] = 1.0                       # unique max at (1, 1)
        x[0, 0, 1, 2] = x[0, 1, 0, 2] = 1.0       # tie: (0, 1) first
    pool2x2(x).sum().backward()                   # channel 0: all tie
    g = x.grad[0]
    assert g[0, 0, 0] == 1 and g[..., 0].sum() == 1
    assert g[1, 1, 1] == 1 and g[..., 1].sum() == 1
    assert g[0, 1, 2] == 1 and g[..., 2].sum() == 1
    with torch.no_grad():                         # no codes, no graph
        assert not pool2x2(x).requires_grad


def test_chamfer_grads_match_jax(rng):
    x, y = _clouds(rng, 2, 256, 256)
    w1, w2 = 1.0, 0.5
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    loss = chamfer_distance(tx, ty, w1, w2)
    (loss * torch.tensor([1.0, 2.0])).sum().backward()

    def f(a, b):
        cd = jax_chamfer(a, b, w1, w2, impl="pallas")
        return jnp.sum(cd * jnp.asarray([1.0, 2.0]))

    ref_loss = jax_chamfer(jnp.asarray(x), jnp.asarray(y), w1, w2,
                           impl="pallas")
    gx, gy = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref_loss),
                               rtol=1e-5)
    for got, ref in ((tx.grad, gx), (ty.grad, gy)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        segment_sum(torch.zeros(2, 4, 9), torch.zeros(2, 4, dtype=torch.int32),
                    4)
    with pytest.raises(TypeError):
        segment_sum(torch.zeros(2, 4, 3, dtype=torch.float64),
                    torch.zeros(2, 4, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        nn_both(torch.zeros(2, 4, 3), torch.zeros(3, 4, 3))
    with pytest.raises(ValueError):
        maxpool2x2_bwd(torch.zeros(1, 2, 2, 4),
                       torch.zeros(1, 2, 2, 4, dtype=torch.int32))
