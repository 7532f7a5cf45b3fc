"""The port's Sinkhorn EMD (``fpsg_torch/ops/emd.py``) against the JAX
package's, on the CPU.

The port runs its plain version (the CUDA kernels K6/K11 need a card:
``tests/test_torch_cuda.py``); JAX runs ``impl="pallas"``, whose Pallas
kernels ``_sinkhorn_potentials_pallas`` (K6) and
``_sinkhorn_potentials_pallas_warm`` (K11) execute in interpret mode on
the CPU, as in ``tests/test_ops_emd.py``. Inputs come from numpy seeds.

Tolerances, with the differences measured at these seeds in brackets.
The clouds lie in the unit ball, as the corpus's clouds and the decoder's
outputs do (costs up to 4):

- values rtol 1e-3, atol 1e-5: the JAX package's own pallas-vs-oracle
  bound (``tests/test_ops_emd.py:77-82``). The two build the cost in other
  roundings (JAX: a padded HIGHEST-precision matmul; the port: the
  elementwise expansion of ``ops/pairwise.py``) and divide it by eps =
  2e-4, so their iterations part at the level of f32 rounding of C / eps
  (defaults 2.0e-5, multiscale 8.6e-6, euclidean 1.2e-5, mixed batch
  2.7e-5; on standard-normal clouds, with costs near 30, the same gap
  grows to 8e-4);
- potentials at a fixed 80 iterations (tol = 0, eps = 1e-2) within 1e-5
  of their scale (5.9e-7), values there rtol 1e-5 (6.3e-7);
- the gradient with respect to x within 1e-4 of its scale (1.1e-5): it is
  ``P``'s contraction with the cost's derivative, at eps = 1e-2.

Per-cloud exit: in a batch that mixes an easy pair (y = x + small noise,
which exits early) with hard pairs, each cloud's potentials, iteration
count and value equal its own B = 1 solve bit for bit (the plain version
masks finished clouds and reduces each cloud in the same order in any
batch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpsg_torch.ops import emd as T
from fpsg_tpu.ops import emd as J

VAL = dict(rtol=1e-3, atol=1e-5)


def _clouds(seed, b, n, m=None, easy=()):
    """Gaussian clouds scaled into the unit ball, as the corpus's clouds
    and the decoder's outputs are."""
    rng = np.random.default_rng(seed)

    def cloud(k):
        p = rng.standard_normal((b, k, 3))
        return (p / np.linalg.norm(p, axis=-1).max(axis=-1)[:, None, None]
                ).astype(np.float32)

    x, y = cloud(n), cloud(m or n)
    for i in easy:                                  # y = x + small noise
        y[i] = x[i] + 0.01 * rng.standard_normal((n, 3)).astype(np.float32)
    return x, y


def _both(x, y, **kw):
    # JAX's "auto": the Pallas kernels for the squared cost, else oracle
    ref = np.asarray(J.sinkhorn_emd(jnp.asarray(x), jnp.asarray(y), **kw))
    got = T.sinkhorn_emd(torch.from_numpy(x), torch.from_numpy(y), **kw)
    return got.numpy(), ref


@pytest.mark.parametrize("omega", [1.0, 1.6])
def test_defaults_match_jax(omega):
    """The evaluator's call (eps 2e-4, 360 iterations, anneal from 0.1,
    early exit at 1e-6) at (2, 64, 3), with and without over-relaxation."""
    x, y = _clouds(0, 2, 64)
    got, ref = _both(x, y, omega=omega)
    np.testing.assert_allclose(got, ref, **VAL)


def test_fixed_iterations_match_jax_potentials():
    """tol = 0 runs all 80 iterations: the potentials of K6 and of the
    warm-started K11 against the Pallas kernels' directly, and the
    values."""
    x, y = _clouds(1, 2, 64, 48)
    kw = dict(eps=1e-2, n_iters=80, anneal_frac=0.5, eps0=0.1, tol=0.0,
              omega=1.6)
    fj, gj = J._sinkhorn_potentials_pallas(jnp.asarray(x), jnp.asarray(y),
                                           **kw)
    ft, gt, it = T.sinkhorn_potentials(torch.from_numpy(x),
                                       torch.from_numpy(y), **kw)
    assert it.tolist() == [80, 80]
    g0 = 0.01 * np.random.default_rng(2).standard_normal((2, 48)).astype(
        np.float32)
    wkw = dict(eps=1e-2, n_iters=80, tol=0.0, omega=1.6, eps0=0.05,
               anneal_frac=0.4)
    fjw, gjw = J._sinkhorn_potentials_pallas_warm(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(g0), **wkw)
    ftw, gtw, _ = T.sinkhorn_potentials(
        torch.from_numpy(x), torch.from_numpy(y), g0=torch.from_numpy(g0),
        **wkw)
    for got, ref in ((ft, fj), (gt, gj), (ftw, fjw), (gtw, gjw)):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale
    got, ref = _both(x, y, eps=1e-2, n_iters=80, tol=0.0)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_multiscale_matches_jax():
    """``coarse=128`` at (2, 512, 3): K6 on a strided subsample, the
    c-transform, then K11; and below 4 x coarse the cold solve."""
    x, y = _clouds(3, 2, 512)
    got, ref = _both(x, y, coarse=128)
    np.testing.assert_allclose(got, ref, **VAL)
    small, _ = _clouds(4, 1, 64)
    a = T.sinkhorn_emd(torch.from_numpy(small), torch.from_numpy(small[::-1]
                                                                .copy()),
                       coarse=32)
    b = T.sinkhorn_emd(torch.from_numpy(small), torch.from_numpy(small[::-1]
                                                                .copy()))
    assert torch.equal(a, b)


def test_euclidean_cost_matches_jax_oracle():
    """The euclidean ground cost runs JAX's materialized oracle loop (a
    batch-wide exit) on both sides."""
    x, y = _clouds(5, 2, 32)
    got, ref = _both(x, y, cost="euclidean", n_iters=50)
    np.testing.assert_allclose(got, ref, **VAL)


def test_reduce_modes_and_wrapper():
    x, y = _clouds(6, 3, 32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    per = T.sinkhorn_emd(xt, yt)
    assert per.shape == (3,)
    torch.testing.assert_close(T.sinkhorn_emd(xt, yt, reduce="sum"),
                               per.sum(), rtol=1e-6, atol=0)
    torch.testing.assert_close(T.sinkhorn_emd(xt, yt, reduce="mean"),
                               per.mean(), rtol=1e-6, atol=0)
    torch.testing.assert_close(T.emd_wrapper(xt, yt), per.sum(), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(
        float(T.emd_wrapper(xt, yt)),
        float(J.emd_wrapper(jnp.asarray(x), jnp.asarray(y))), **VAL)
    # 2-D inputs are one batch element; bf16 inputs are cast to f32 first
    assert T.sinkhorn_emd(xt[0], yt[0]).shape == (1,)
    torch.testing.assert_close(
        T.sinkhorn_emd(xt.bfloat16(), yt.bfloat16()),
        T.sinkhorn_emd(xt.bfloat16().float(), yt.bfloat16().float()),
        rtol=0, atol=0)


def test_gradient_matches_jax():
    """d EMD / d x through the cost alone (the envelope theorem), at the
    training loss's settings."""
    x, y = _clouds(7, 2, 64)
    kw = dict(eps=0.01, n_iters=100, reduce="sum")
    gj = np.asarray(jax.grad(lambda a: J.sinkhorn_emd(
        a, jnp.asarray(y), impl="pallas", **kw))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    T.sinkhorn_emd(xt, torch.from_numpy(y), **kw).backward()
    assert np.abs(xt.grad.numpy() - gj).max() <= 1e-4 * np.abs(gj).max()


def test_exit_is_per_cloud():
    """A cloud's result does not depend on the batch it is solved in: the
    easy pair exits early, the hard ones run on, and each matches its own
    solve bit for bit."""
    x, y = _clouds(8, 3, 64, easy=(1,))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    kw = dict(eps=2e-4, n_iters=360, eps0=0.1, tol=T.DEFAULT_TOL,
              omega=T.DEFAULT_OMEGA)
    f, g, iters = T.sinkhorn_potentials(xt, yt, **kw)
    # the easy pair stops at the first allowed exit (t_anneal + 2), the
    # batch does not: the clouds stop at different iterations
    assert iters[1] == 182 and iters.max() > 182, iters
    batch = T.sinkhorn_emd(xt, yt)
    for i in range(3):
        fi, gi, ii = T.sinkhorn_potentials(xt[i:i + 1], yt[i:i + 1], **kw)
        assert torch.equal(fi[0], f[i]) and torch.equal(gi[0], g[i])
        assert ii[0] == iters[i]
        assert torch.equal(T.sinkhorn_emd(xt[i:i + 1], yt[i:i + 1])[0],
                           batch[i])
    # the values still match JAX's per-cloud kernel
    np.testing.assert_allclose(batch.numpy(), _both(x, y)[1], **VAL)
