"""The port's CUDA kernels against their plain versions, on a card.

Marker ``cuda``: these skip on a host without a CUDA device. On a card
(where JAX is not installed, so the suite's ``conftest.py`` cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Small ragged shapes, to reach the kernels' edge masking; ``chip_smoke.py``
holds the kernels against the plain versions at the serving and training
shapes. Tolerances: f32 rtol/atol 1e-5 (the same products summed in
another order); bf16 2e-2 (outputs round once to bf16, 2^-8 relative, and
another summation order can land on the neighbouring bf16 value). The
pool and its backward, and the Chamfer nearest neighbour, are bitwise; the
segment sum within 1e-6 of its scale (the plain version on the card is
``index_add_`` with float atomics, summed in a varying order). The
single-read statistics kernels (K3f/K3b, K4f/K4b): max/min values,
indices, codes and the backward bitwise; the shifted sums within 1e-6 of
their scale (another summation order). The decoder's training kernels
(K5a/K5d with statistics, K5b, K5c, K5e, K5g) within 1e-5 (f32) or 2e-2
(bf16) of each output's scale, and a small fused training decoder's
gradients on the card within 1e-4 of each leaf's scale of the CPU's. The
Sinkhorn solves (K6, K11): potentials within 1e-5 of their scale at a
fixed iteration count, values within rtol 1e-3 / atol 1e-5 (the JAX
package's own pallas-vs-oracle bound), iteration counts within 2 (exp2f
and the order of the sums against the plain version's exp and sums can
move a delta across tol by an iteration).
"""

import copy

import pytest
import torch

from fpsg_torch.nn import fused_stack as tfs
from fpsg_torch.ops import emd
from fpsg_torch.ops import launch_counts
from fpsg_torch.ops import moments as mo
from fpsg_torch.ops import pool_moments as pm
from fpsg_torch.ops.chamfer import chamfer_distance, nn_both, nn_both_plain
from fpsg_torch.ops.pool import (
    maxpool2x2, maxpool2x2_bwd, maxpool2x2_bwd_plain, maxpool2x2_plain,
    pool2x2,
)
from fpsg_torch.ops.scatter import segment_sum, segment_sum_plain

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kernels_match_plain_on_card(dt):
    """Each CUDA kernel against its plain version on the card, at small
    ragged shapes (the serving shapes are ``chip_smoke.py``'s)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tdt = DTYPES[dt]
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype).cuda()

    x = rnd(2, 10, 14, 24, dtype=tdt)
    y, code = maxpool2x2(x, return_index=True)
    ry, rcode = maxpool2x2_plain(x)
    assert torch.equal(y, ry) and torch.equal(code, rcode)

    tol = dict(rtol=1e-5, atol=1e-5) if dt == "f32" else \
        dict(rtol=2e-2, atol=2e-2)
    yc = rnd(2, 3, 3, 150)
    d, wd = rnd(2, 3, 3 * 40, 3, dtype=tdt), rnd(2, 3, 3, 150, dtype=tdt)
    torch.testing.assert_close(tfs.fused_l1_layer(d, wd, yc, 40),
                               tfs.fused_l1_plain(d, wd, yc, 40), **tol)
    yp, k, b = rnd(2, 3, 300, 139, dtype=tdt), rnd(2, 3, 139), rnd(2, 3, 139)
    w = rnd(2, 3, 139, 131, dtype=tdt) / 12
    torch.testing.assert_close(tfs.fused_mid_layer(yp, k, b, w),
                               tfs.fused_mid_plain(yp, k, b, w), **tol)
    w4, bias = rnd(2, 3, 139, 3, dtype=tdt) / 12, rnd(2, 3, 3)
    torch.testing.assert_close(tfs.fused_out_layer(yp, k, b, w4, bias),
                               tfs.fused_out_plain(yp, k, b, w4, bias), **tol)


@pytest.mark.cuda
def test_training_kernels_match_plain_on_card():
    """The pool backward, the Chamfer nearest neighbour (with forced ties)
    and the segment sum against their plain versions, and the Chamfer
    gradient on the card against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator().manual_seed(1)
    for dt in DTYPES.values():
        x = (torch.randn((2, 10, 14, 24), generator=gen) * 2).round().to(dt)
        _, code = maxpool2x2(x.cuda(), return_index=True)
        g = torch.randn((2, 5, 7, 24), generator=gen).to(dt).cuda()
        assert torch.equal(maxpool2x2_bwd(g, code),
                           maxpool2x2_bwd_plain(g, code))
    xr = torch.randn((2, 6, 8, 16), generator=gen).cuda().requires_grad_()
    pool2x2(xr).sum().backward()
    assert xr.grad.sum().item() == 2 * 3 * 4 * 16

    x = torch.randn((3, 300, 3), generator=gen)
    y = torch.randn((3, 257, 3), generator=gen)
    y[:, 9:18] = y[:, 0:9]                         # exact ties
    x[:, 100:110] = x[:, 0:10]
    got = nn_both(x.cuda(), y.cuda())
    for a, b in zip(got, nn_both_plain(x.cuda(), y.cuda())):
        assert torch.equal(a, b)
    vals = torch.randn((3, 300, 3), generator=gen).cuda()
    ref = segment_sum_plain(vals, got[1], 257)
    err = (segment_sum(vals, got[1], 257) - ref).abs().max().item()
    assert err <= 1e-6 * ref.abs().max().item()

    xc, yc = x.clone().requires_grad_(), y.clone().requires_grad_()
    xg, yg = x.cuda().requires_grad_(), y.cuda().requires_grad_()
    chamfer_distance(xc, yc).sum().backward()
    chamfer_distance(xg, yg).sum().backward()
    torch.testing.assert_close(xg.grad.cpu(), xc.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(yg.grad.cpu(), yc.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_stat_kernels_match_plain_on_card():
    """K3f/K3b and K4f/K4b against their plain versions on the card, with
    forced ties, on the vector path (channels a multiple of 16 bytes) and
    the scalar path (ragged channels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator().manual_seed(2)

    def rnd(*shape, dtype=torch.float32, ties=False):
        x = torch.randn(shape, generator=gen)
        if ties:
            x = (x * 2).round() / 2                # many equal values
        return x.to(dtype).cuda()

    def sums_close(got, ref):
        assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()

    for dt in DTYPES.values():
        for f in (136, 21):                        # vector, scalar path
            y, s = rnd(3, 257, f, dtype=dt, ties=True), rnd(f)
            got = mo.moments_fwd(y, s)
            ref = mo.moments_fwd_plain(y, s)
            sums_close(got[0], ref[0])
            sums_close(got[1], ref[1])
            for k in (2, 3, 4, 5):
                assert torch.equal(got[k], ref[k])
            cots = (rnd(f), rnd(f), rnd(3, f), got[3], rnd(3, f), got[5])
            args = (y, s, cots[0], cots[1], cots[2], cots[3], cots[4],
                    cots[5])
            assert torch.equal(mo.moments_bwd(*args),
                               mo.moments_bwd_plain(*args))
        for c in (72, 13):                         # vector, scalar path
            y, s = rnd(2, 10, 7, 2 * c, dtype=dt, ties=True), rnd(c)
            got = pm.pool_moments_fwd(y, s)
            ref = pm.pool_moments_fwd_plain(y, s)
            sums_close(got[0], ref[0])
            sums_close(got[1], ref[1])
            for k in (2, 3, 4, 5):
                assert torch.equal(got[k], ref[k])
            args = (y, s, rnd(c), rnd(c), rnd(2, 5, 7, c, dtype=dt), got[3],
                    rnd(2, 5, 7, c, dtype=dt), got[5])
            assert torch.equal(pm.pool_moments_bwd(*args),
                               pm.pool_moments_bwd_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_training_kernels_match_plain_on_card(dt):
    """K5a/K5d with statistics and the backward kernels K5b, K5c, K5e, K5g
    against their plain versions on the card at small ragged shapes (rows
    and widths not multiples of the tiles), with and without statistics,
    and a small fused training decoder's gradients against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tdt = DTYPES[dt]
    gen = torch.Generator().manual_seed(3)

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).cuda()

    def close(got, ref):
        got, ref = got.float(), ref.float()
        scale = ref.abs().max().item()
        tol = 1e-5 if dt == "f32" else 2e-2
        assert (got - ref).abs().max().item() <= tol * max(scale, 1e-30)

    c, n, p, b = 2, 3, 40, 3
    r, d0, d1, d2 = p * b, 150, 139, 67
    yp, k, bb = rnd(c, n, r, d1, dtype=tdt), rnd(c, n, d1), rnd(c, n, d1)
    k = k.abs() + 0.5
    w = rnd(c, n, d1, d2, dtype=tdt, scale=d1 ** -0.5)
    s, gzs, gzq = rnd(c, n, d2), rnd(c, n, d2), rnd(c, n, d2, scale=0.1)
    for a, ref in zip(tfs.fused_mid_kernel(yp, k, bb, w, s),
                      tfs.fused_mid_plain(yp, k, bb, w, s)):
        close(a, ref)
    y = tfs.fused_mid_kernel(yp, k, bb, w, s)[0]
    gy = rnd(c, n, r, d2, dtype=tdt)
    for st in (True, False):
        args = (yp, k, bb, w, s if st else None, y, gy,
                gzs if st else None, gzq if st else None)
        for a, ref in zip(tfs.fused_mid_dx_kernel(*args),
                          tfs.fused_mid_dx_plain(*args)):
            close(a, ref)
        dargs = (*args[:3], *args[4:], tdt)
        close(tfs.fused_mid_dw_kernel(*dargs), tfs.fused_mid_dw_plain(*dargs))

    d, wd = rnd(c, n, r, 3, dtype=tdt).tanh(), rnd(c, n, 3, d0, dtype=tdt)
    yc = rnd(c, n, b, d0)
    sc = yc - yc.mean(dim=2, keepdim=True)
    for a, ref in zip(tfs.fused_l1_kernel(d, wd, yc, p, sc),
                      tfs.fused_l1_plain(d, wd, yc, p, sc)):
        close(a, ref)
    y1 = tfs.fused_l1_kernel(d, wd, yc, p, sc)[0]
    gy1 = rnd(c, n, r, d0, dtype=tdt)
    g3 = [rnd(c, n, d0, scale=0.1) for _ in range(3)]
    for st in (True, False):
        args = (d, wd, yc, sc if st else None, y1, gy1,
                *(g3 if st else (None,) * 3), p)
        for a, ref in zip(tfs.fused_l1_bwd_kernel(*args),
                          tfs.fused_l1_bwd_plain(*args)):
            if ref is None:
                assert a is None
            else:
                close(a, ref)

    w4, bias = rnd(c, n, d1, 3, dtype=tdt, scale=0.1), rnd(c, n, 3)
    yo = tfs.fused_out_kernel(yp, k, bb, w4, bias)
    gyo = rnd(c, n, r, 3)
    for a, ref in zip(tfs.fused_out_bwd_kernel(yp, k, bb, w4, yo, gyo),
                      tfs.fused_out_bwd_plain(yp, k, bb, w4, yo, gyo)):
        close(a, ref)

    if dt == "f32":
        from fpsg_torch.nn.decoder import PrimitiveDecoder

        dec = PrimitiveDecoder(num_clusters=2, num_nodes=2, num_points=64,
                               bottleneck_size=64, d_cond=64, fused="on",
                               generator=torch.Generator().manual_seed(0))
        h = torch.randn((3, 64), generator=gen)
        tp = dec.template_points(3, torch.Generator().manual_seed(1))
        grads = []
        for dev in ("cpu", "cuda"):
            twin = copy.deepcopy(dec).to(dev).train()
            twin(h.to(dev), tp.to(dev)).square().mean().backward()
            grads.append({nm: q.grad.cpu() for nm, q in
                          twin.named_parameters() if q.grad is not None})
        for nm, g in grads[0].items():
            assert (grads[1][nm] - g).abs().max() <= 1e-4 * g.abs().max(), nm


@pytest.mark.cuda
def test_sinkhorn_kernels_match_plain_on_card():
    """K6 and K11 against the plain version on the card at small ragged
    shapes (N != M, a partial 1024-column tile, a partial 32-row block),
    with a batch that mixes an easy pair with hard ones so that clouds
    exit at different iterations; ``sinkhorn_emd`` and its gradient on the
    card against the CPU; one launch counted per solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator().manual_seed(4)

    def cloud(*shape):
        p = torch.randn(shape, generator=gen)
        return p / p.norm(dim=-1).amax(dim=-1)[..., None, None]

    x, y = cloud(3, 300, 3), cloud(3, 1100, 3)
    fixed = dict(eps=1e-2, n_iters=80, anneal_frac=0.5, eps0=0.1, tol=0.0,
                 omega=1.6)
    g0 = 0.01 * torch.randn((3, 1100), generator=gen)
    for extra in ({}, {"g0": g0.cuda(), "eps0": 0.05, "anneal_frac": 0.4}):
        kw = {**fixed, **extra}
        before = launch_counts()
        got = emd.sinkhorn_potentials(x.cuda(), y.cuda(), **kw)
        ref = emd.sinkhorn_potentials_plain(x.cuda(), y.cuda(), **kw)
        name = emd.KERNEL_WARM if extra else emd.KERNEL
        assert launch_counts()[name] - before[name] == 1
        for a, r in zip(got[:2], ref[:2]):
            assert (a - r).abs().max() <= 1e-5 * r.abs().max()
        assert got[2].tolist() == [80, 80, 80]

    x, y = cloud(4, 300, 3), cloud(4, 300, 3)
    y[1] = x[1] + 0.01 * torch.randn((300, 3), generator=gen)
    kw = dict(eps=2e-4, n_iters=360, anneal_frac=0.5, eps0=0.1,
              tol=emd.DEFAULT_TOL, omega=emd.DEFAULT_OMEGA)
    got = emd.sinkhorn_potentials(x.cuda(), y.cuda(), **kw)
    ref = emd.sinkhorn_potentials_plain(x.cuda(), y.cuda(), **kw)
    assert (got[2] - ref[2]).abs().max() <= 2, (got[2], ref[2])
    assert got[2][1] == got[2].min() and got[2][1] < got[2].max(), got[2]
    c = emd.pairwise_sqdist(x.cuda(), y.cuda())
    torch.testing.assert_close(emd.transport_cost(c, got[0], got[1], 2e-4),
                               emd.transport_cost(c, ref[0], ref[1], 2e-4),
                               rtol=1e-3, atol=1e-5)

    xc, xg = x.clone().requires_grad_(), x.cuda().requires_grad_()
    vc = emd.sinkhorn_emd(xc, y, eps=0.01, n_iters=100, reduce="sum")
    vg = emd.sinkhorn_emd(xg, y.cuda(), eps=0.01, n_iters=100, reduce="sum")
    torch.testing.assert_close(vg.cpu(), vc, rtol=1e-3, atol=1e-5)
    vc.backward()
    vg.backward()
    assert (xg.grad.cpu() - xc.grad).abs().max() <= 1e-4 * xc.grad.abs().max()
