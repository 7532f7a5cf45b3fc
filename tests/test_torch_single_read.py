"""The training modules with single-read BatchNorm statistics against the
JAX package, on the CPU (f32).

The JAX side runs with ``precise_stats=False`` and ``decoder_fused="off"``,
its K3 and K4 Pallas kernels forced on in interpret mode through its own
test hooks (``fpsg_tpu.nn.pointnet._FORCE_MOMENTS_KERNEL``,
``fpsg_tpu.nn.vgg._FORCE_POOL_KERNEL``), so both sides route the pool
and max cotangents to the first maximal element. The port runs the plain
versions of its kernels.

- BatchNorm single-read (``two_pass=False``) on the channel, grouped
  deformer and node cases of ``test_torch_train_modules.py``: output,
  gradients and running statistics, with its tolerances.
- stats injection (``stat_shift``, ``affine_from_stats``): the shift,
  ``(k, b_eff)`` and the running statistics within 1e-6 relative (the
  same formulas in f32; measured at most 1.6e-7).
- ``bn_maxpool`` (one PointNet site) and ``_bn_pool_fused`` (one VGG BN ->
  pool site), with some negative BatchNorm scales so that both the max and
  the min are taken: output, the input's and the parameters' gradients,
  and the running statistics within 1e-5 of their scale (measured at most
  2.1e-7).
- the decoder's training chain, the whole PointNet and the whole VGG16-bn
  at 32x32 in training: outputs rtol 1e-4 and atol 1e-5 of the scale
  (decoder 5e-5, as in ``test_torch_train_modules.py``), running
  statistics rtol 1e-4, atol 1e-6; the decoder's and PointNet's gradients
  by ``grads_close`` (1e-4 of each leaf's max). The VGG gradients are held
  to a noise floor instead: at full depth the single-read statistics'
  ~1e-7 reassociation flips the routing of near-tie pool windows, which
  moves O(1) of cotangent (``tests/test_pool_moments.py:171-216``). The
  floor is the port's own gradient change when the input moves by 1e-6
  (relative Frobenius norm per leaf); each leaf's JAX-vs-port distance
  must stay within 3x its floor or 1e-4.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpsg_tpu.nn.pointnet as jpn
import fpsg_tpu.nn.vgg as jvgg
from fpsg_torch.config import FPSGConfig
from fpsg_torch.io.bridge import state_dict_from_jax
from fpsg_torch.models import build_model
from fpsg_torch.nn.normalization import BatchNorm
from fpsg_torch.nn.pointnet import bn_maxpool
from fpsg_torch.nn.vgg import _bn_pool_fused
from fpsg_tpu.models.protonet import ImgPCProtoNet as JaxNet
from fpsg_tpu.nn.normalization import BatchNorm as JaxBatchNorm
from test_torch_train_modules import (
    BN_CASES, _close, _jax_train, _perturb, _port_train, check_batchnorm_case,
    grads_close, stats_close,
)

IMG, NPTS, C, NN, BOTTLENECK = 32, 64, 2, 2, 256
PPN = NPTS // C // NN


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def forced_kernels():
    """The JAX package's K3/K4 Pallas kernels in interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpn, "_FORCE_MOMENTS_KERNEL", True)
        mp.setattr(jvgg, "_FORCE_POOL_KERNEL", True)
        yield


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_single_read_matches_jax(rng, case):
    check_batchnorm_case(rng, case, two_pass=False)


def _bn_variables(rng, f):
    scale = rng.uniform(0.5, 1.5, f).astype(np.float32)
    scale[::5] *= -1                     # some k < 0: the min is selected
    return {"params": {"scale": scale,
                       "bias": (0.1 * rng.standard_normal(f)).astype(
                           np.float32)},
            "batch_stats": {"mean": (0.1 * rng.standard_normal(f)).astype(
                                np.float32),
                            "var": rng.uniform(0.5, 1.5, f).astype(
                                np.float32)}}


def _port_bn(v, f):
    bn = BatchNorm((f,), activation="relu", two_pass=False).train()
    with torch.no_grad():
        for name, a in (("weight", v["params"]["scale"]),
                        ("bias", v["params"]["bias"]),
                        ("running_mean", v["batch_stats"]["mean"]),
                        ("running_var", v["batch_stats"]["var"])):
            getattr(bn, name).copy_(torch.from_numpy(a))
    return bn


def test_stats_injection_matches_jax(rng):
    f, n = 16, 300
    v = _bn_variables(rng, f)
    shift = rng.standard_normal(f).astype(np.float32)
    mean = rng.standard_normal(f).astype(np.float32)
    var = rng.uniform(0.1, 2, f).astype(np.float32)
    jbn = JaxBatchNorm(two_pass=False, activation="relu")
    s_ref = jbn.apply(v, None, True, shift=jnp.asarray(shift),
                      return_shift=True, param_shape_hint=(f,))
    (k_ref, b_ref), mut = jbn.apply(
        v, None, False, shift=jnp.asarray(shift),
        stats=(jnp.asarray(mean), jnp.asarray(var), n), return_affine=True,
        mutable=["batch_stats"])
    bn = _port_bn(v, f)
    ts = torch.from_numpy(shift)
    s = bn.stat_shift(ts)
    k, b = bn.affine_from_stats(torch.from_numpy(mean), torch.from_numpy(var),
                                n, shift=ts)
    for got, ref in ((s, s_ref), (k, k_ref), (b, b_ref),
                     (bn.running_mean, mut["batch_stats"]["mean"]),
                     (bn.running_var, mut["batch_stats"]["var"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-7)
    assert not s.requires_grad and k.dtype == torch.float32


class _JaxSite(fnn.Module):
    """One JAX site: ``kind`` "pointnet" (``_bn_maxpool``, relu) or "vgg"
    (``_bn_pool_fused`` on the packed layout)."""
    kind: str

    @fnn.compact
    def __call__(self, y, b):
        bn = JaxBatchNorm(two_pass=False, activation="relu", name="bn")
        if self.kind == "pointnet":
            return jpn._bn_maxpool(y, b, bn, True, True, None)
        return jvgg._bn_pool_fused(y, b, bn, None)


@pytest.mark.parametrize("kind", ["pointnet", "vgg"])
def test_stat_kernel_site_matches_jax(rng, forced_kernels, kind):
    f = 128
    if kind == "pointnet":
        y = rng.standard_normal((3, 200, f)).astype(np.float32)
        cot_shape = (3, f)
    else:
        y = rng.standard_normal((2, 8, 12, f)).astype(np.float32)
        cot_shape = (2, 4, 6, f)
    y += 0.3                                       # a mean to track
    fold = (0.1 * rng.standard_normal(f)).astype(np.float32)
    cot = rng.standard_normal(cot_shape).astype(np.float32)
    v = _bn_variables(rng, f)
    site = _JaxSite(kind)
    jy = jnp.asarray(y if kind == "pointnet" else y.reshape(2, 8, 6, 2 * f))

    def run(yy, params):
        return site.apply({"params": params,
                           "batch_stats": {"bn": v["batch_stats"]}},
                          yy, jnp.asarray(fold), mutable=["batch_stats"])

    ref, vjp, mut = jax.vjp(run, jy, {"bn": v["params"]}, has_aux=True)
    gy_ref, gp_ref = vjp(jnp.asarray(cot))
    bn = _port_bn(v, f)
    ty = torch.from_numpy(y).requires_grad_()
    tb = torch.from_numpy(fold)
    out = bn_maxpool(ty, tb, bn, True, None) if kind == "pointnet" else \
        _bn_pool_fused(ty, tb, bn, None)
    out.backward(torch.from_numpy(cot))
    for got, want in ((out.detach(), ref),
                      (ty.grad, np.asarray(gy_ref).reshape(y.shape)),
                      (bn.weight.grad, gp_ref["bn"]["scale"]),
                      (bn.bias.grad, gp_ref["bn"]["bias"]),
                      (bn.running_mean, mut["batch_stats"]["bn"]["mean"]),
                      (bn.running_var, mut["batch_stats"]["bn"]["var"])):
        _close(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def world():
    """A JAX net with single-read statistics and the unfused decoder, its
    perturbed variables, and a factory of port models with its weights."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    net = JaxNet(num_clusters=C, num_nodes=NN, num_points=NPTS,
                 bottleneck_size=BOTTLENECK, decoder_fused="off")
    v = jax.jit(lambda k: net.init(
        {"params": k, "template": k},
        {"xq": jnp.zeros((2, IMG, IMG, 3)), "pcs": jnp.zeros((3, NPTS, 3))},
        method=net.generate))(jax.random.PRNGKey(0))
    v = jax.device_get(_perturb(v, rng))
    sd = state_dict_from_jax(v)

    def port():
        model = build_model(FPSGConfig(num_clusters=C, num_nodes=NN,
                                       num_pts=NPTS,
                                       bottleneck_size=BOTTLENECK))
        model.load_state_dict(sd)
        return model.train()

    inputs = {
        "xq": rng.uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32),
        "pcs": (0.3 * rng.standard_normal((4, NPTS, 3))).astype(np.float32),
        "h": rng.standard_normal((3, 1536)).astype(np.float32),
        "tp": rng.uniform(0, 1, (3, C, NN, PPN, 2)).astype(np.float32),
    }
    return net, v, port, inputs


def test_decoder_single_read_matches_jax(world):
    net, v, port, x = world
    model = port()
    assert model.pc_decoder.node_bn1.two_pass
    assert not model.pc_decoder.node_bn2.two_pass
    cot = np.random.default_rng(3).standard_normal((3, NPTS, 3)).astype(
        np.float32)
    ref, grads, stats = _jax_train(
        net, v, lambda m, h, tp: m.pc_decoder(h, True, tp),
        (x["h"], x["tp"]), cot)
    got = _port_train(model.pc_decoder, (x["h"], x["tp"]), cot)
    _close(got, ref, atol=5e-5)
    grads_close(model, "pc_decoder.", grads)
    stats_close(model, "pc_decoder.", stats)


def test_pointnet_single_read_matches_jax(world, forced_kernels):
    net, v, port, x = world
    model = port()
    cot = np.random.default_rng(2).standard_normal((4, 1024)).astype(
        np.float32)
    ref, grads, stats = _jax_train(
        net, v, lambda m, p: m.pc_encoder(p, True), (x["pcs"],), cot)
    got = _port_train(model.pc_encoder, (x["pcs"],), cot)
    _close(got, ref)
    grads_close(model, "pc_encoder.", grads)
    stats_close(model, "pc_encoder.", stats)


def test_vgg_single_read_matches_jax(world, forced_kernels):
    net, v, port, x = world
    cot = np.random.default_rng(1).standard_normal((3, 512)).astype(
        np.float32)
    ref, grads, stats = _jax_train(
        net, v, lambda m, i: m.img_encoder(i, True), (x["xq"],), cot)
    model = port()
    got = _port_train(model.img_encoder, (x["xq"],), cot)
    _close(got, ref)
    stats_close(model, "img_encoder.", stats, atol=1e-6)
    ours = {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}
    nudged = port()
    noise = 1e-6 * np.random.default_rng(4).standard_normal(x["xq"].shape)
    _port_train(nudged.img_encoder, ((x["xq"] + noise).astype(np.float32),),
                cot)
    theirs = state_dict_from_jax({"params": grads})
    for name, g in ours.items():
        nudge = dict(nudged.named_parameters())[name].grad
        ref_g = theirs[name]
        norm = float(ref_g.norm()) + 1e-12
        dist = float((g - ref_g).norm()) / norm
        floor = float((nudge - g).norm()) / norm
        assert dist <= max(3.0 * floor, 1e-4), (name, dist, floor)
