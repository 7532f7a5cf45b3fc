"""The training slice's modules in train mode against the JAX package.

One small JAX ``ImgPCProtoNet`` (2 clusters x 2 nodes, 64 points,
bottleneck 256, full VGG16 at 32x32, ``precise_stats=True``) is
initialized once per module, its BatchNorm running statistics and affine
parameters are perturbed away from 0/1, and its variables cross into the
port through ``fpsg_torch.io.bridge``. Each module runs in training mode on
both sides on the same numpy inputs; the forward, the gradient of every
parameter under one random cotangent (``jax.vjp`` against
``torch.autograd``) and the running statistics after the update are
compared. Also: BatchNorm's training mode on its own (group statistics,
the folded shift, the sequential running-stat fold) and the episode
sampler's semantics.

Tolerances: outputs rtol 1e-4, atol 1e-5 x max|ref| (the decoder 5e-5,
see its test); gradients atol 1e-4 x
max|ref| per leaf (see ``grads_close``); running statistics rtol 1e-5, atol
1e-6. All f32: XLA
and ATen sum convs, matmuls and reductions in other orders, and ~15 layers
of batch statistics pass the differences on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpsg_torch.data.corpus import DeviceCorpus, sample_episode
from fpsg_torch.data.synthetic import synthetic_device_corpus
from fpsg_torch.io.bridge import state_dict_from_jax
from fpsg_torch.models import build_model
from fpsg_torch.config import FPSGConfig
from fpsg_torch.nn.normalization import BatchNorm
from fpsg_tpu.models.protonet import ImgPCProtoNet as JaxNet
from fpsg_tpu.nn.normalization import BatchNorm as JaxBatchNorm

IMG, NPTS, C, NN, BOTTLENECK = 32, 64, 2, 2, 256
PPN = NPTS // C // NN


def _close(got, ref, rtol=1e-4, atol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol * float(np.abs(ref).max()))


def grads_close(model, prefix, jax_grads, tol=1e-4):
    """Every port parameter under ``prefix`` against the JAX gradient
    tree (through the bridge's name and layout map), within ``tol`` of the
    leaf's max. A leaf whose gradient is cancellation noise, below 1e-3 of
    the largest gradient under ``prefix`` (STN ``bn3.bias``: a shift that
    ``fc1``'s BatchNorm removes again), is held to ``tol`` x 1e-3 of that
    largest instead. A bias folded into a BatchNorm has no gradient in the port
    and exactly 0 in JAX."""
    ref = state_dict_from_jax({"params": jax_grads})
    names = [n for n, _ in model.named_parameters() if n.startswith(prefix)]
    top = max(float(np.abs(ref[n].numpy()).max()) for n in names)
    checked = 0
    for name, p in model.named_parameters():
        if name not in names:
            continue
        r = ref[name].numpy()
        if p.grad is None:
            assert not r.any(), f"{name}: JAX gradient is not 0"
            continue
        scale = max(float(np.abs(r).max()), 1e-3 * top)
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=tol * scale, err_msg=name)
        checked += 1
    assert checked > 0


def stats_close(model, prefix, jax_stats, atol=1e-6):
    ref = state_dict_from_jax({"batch_stats": jax_stats})
    names = [k for k in ref if k.startswith(prefix)]
    assert names
    sd = model.state_dict()
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(), rtol=1e-5,
                                   atol=atol, err_msg=k)


def _perturb(variables, rng):
    def stats(path, a):
        a = np.asarray(a)
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    def params(path, a):
        a = np.asarray(a)
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if path[-1].key == "bias" and "bn" in str(path):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return {"params": jax.tree_util.tree_map_with_path(
                params, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stats, variables["batch_stats"])}


@pytest.fixture(scope="module")
def world():
    """(JAX net, its variables as numpy, a function making a fresh port
    model in train mode with the same weights, numpy inputs)."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    net = JaxNet(num_clusters=C, num_nodes=NN, num_points=NPTS,
                 bottleneck_size=BOTTLENECK, precise_stats=True,
                 decoder_fused="off")
    v = jax.jit(lambda k: net.init(
        {"params": k, "template": k},
        {"xq": jnp.zeros((2, IMG, IMG, 3)), "pcs": jnp.zeros((3, NPTS, 3))},
        method=net.generate))(jax.random.PRNGKey(0))
    v = jax.device_get(_perturb(v, rng))
    sd = state_dict_from_jax(v)

    def port():
        model = build_model(FPSGConfig(num_clusters=C, num_nodes=NN,
                                       num_pts=NPTS,
                                       bottleneck_size=BOTTLENECK,
                                       precise_stats=True))
        model.load_state_dict(sd)
        return model.train()

    inputs = {
        "xq": rng.uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32),
        "pcs": (0.3 * rng.standard_normal((4, NPTS, 3))).astype(np.float32),
        "h": rng.standard_normal((3, 1536)).astype(np.float32),
        "tp": rng.uniform(0, 1, (3, C, NN, PPN, 2)).astype(np.float32),
    }
    return net, v, port, inputs


def _jax_train(net, v, method, args, cot):
    """Train-mode forward, the parameter gradient under ``cot`` and the
    updated running statistics of one submodule (jitted: one compile is
    cheaper than the eager op-by-op dispatch)."""
    @jax.jit
    def run(variables, args, cot):
        def f(params):
            return net.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                *args, method=method, mutable=["batch_stats"])

        out, vjp, mut = jax.vjp(f, variables["params"], has_aux=True)
        return out, vjp(cot)[0], mut["batch_stats"]

    out, grads, stats = jax.device_get(run(v, args, cot))
    return np.asarray(out), grads, stats


def _port_train(module, args, cot):
    out = module(*[torch.from_numpy(a) for a in args])
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy()


def test_vgg_train_matches_jax(world):
    net, v, port, x = world
    model = port()
    cot = np.random.default_rng(1).standard_normal((3, 512)).astype(
        np.float32)
    ref, grads, stats = _jax_train(
        net, v, lambda m, i: m.img_encoder(i, True), (x["xq"],), cot)
    got = _port_train(model.img_encoder, (x["xq"],), cot)
    _close(got, ref)
    grads_close(model, "img_encoder.", grads)
    stats_close(model, "img_encoder.", stats)


def test_pointnet_train_matches_jax(world):
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


def test_decoder_train_matches_jax(world):
    net, v, port, x = world
    model = port()
    cot = np.random.default_rng(3).standard_normal((3, NPTS, 3)).astype(
        np.float32)
    ref, grads, stats = _jax_train(
        net, v, lambda m, h, tp: m.pc_decoder(h, True, tp),
        (x["h"], x["tp"]), cot)
    got = _port_train(model.pc_decoder, (x["h"], x["tp"]), cot)
    # node_bn1 normalizes channels that are nearly constant over each
    # cloud's points (the hoisted conditioning term) by their small batch
    # spread, which magnifies summation-order differences: measured
    # 2.2e-5 of the output scale
    _close(got, ref, atol=5e-5)
    grads_close(model, "pc_decoder.", grads)
    stats_close(model, "pc_decoder.", stats)


# -- BatchNorm on its own ----------------------------------------------------

BN_CASES = {
    # name: (input shape, JAX feature/group axes, port feature axes,
    #        port layout of the input as a permutation of the JAX one)
    "channel": ((6, 50, 16), (-1,), (), (-1,), None),
    "deformer": ((3, 2, 4, 5, 8), (1, -1), (2,), (1, -1), None),
    "node": ((3, 2, 2, 5, 8), (1, 2, -1), (), (0, 1, -1), (1, 2, 0, 3, 4)),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_train_matches_jax(rng, case):
    check_batchnorm_case(rng, case, two_pass=True)


def check_batchnorm_case(rng, case, two_pass):
    """One ``BN_CASES`` BatchNorm in training, JAX against the port with
    the same parameters, running statistics, shift, input and cotangent:
    output, input and parameter gradients, updated running statistics."""
    shape, jf, jg, tf, perm = BN_CASES[case]
    jbn = JaxBatchNorm(feature_axes=jf, group_axes=jg, two_pass=two_pass,
                       activation="relu")
    x = (2.0 + rng.standard_normal(shape)).astype(np.float32)
    pshape = tuple(shape[a] for a in sorted(a % len(shape) for a in jf))
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    scale, bias = 1.0 + 0.3 * f32(*pshape), 0.3 * f32(*pshape)
    rmean, rvar = f32(*pshape), rng.uniform(0.5, 2, pshape).astype(np.float32)
    shift = f32(*pshape)
    cot = f32(*shape)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": rmean, "var": rvar}}

    def f(xx, p):
        return jbn.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, xx,
            False, shift=jnp.asarray(shift), mutable=["batch_stats"])

    ref, vjp, mut = jax.vjp(f, jnp.asarray(x), variables["params"],
                            has_aux=True)
    gx_ref, gp_ref = vjp(jnp.asarray(cot))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    bn = BatchNorm(pshape, tf, activation="relu", group_axes=jg,
                   two_pass=two_pass).train()
    with torch.no_grad():
        for name, a in (("weight", scale), ("bias", bias),
                        ("running_mean", rmean), ("running_var", rvar)):
            getattr(bn, name).copy_(t(a))
    perm = perm or tuple(range(len(shape)))
    inv = np.argsort(perm)
    tx = t(x.transpose(perm)).requires_grad_()
    out = bn(tx, shift=t(shift))
    out.backward(t(cot.transpose(perm)))
    _close(out.detach().numpy().transpose(inv), ref)
    _close(tx.grad.numpy().transpose(inv), gx_ref, atol=1e-4)
    _close(bn.weight.grad.numpy(), gp_ref["scale"], atol=1e-4)
    _close(bn.bias.grad.numpy(), gp_ref["bias"], atol=1e-4)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(mut["batch_stats"][key]),
                                   rtol=1e-5, atol=1e-6)


def test_group_statistics_are_per_group_with_a_sequential_fold():
    """Two groups with different statistics: each is normalized with its
    own, and the running estimate is the two torch updates in order."""
    a = torch.tensor([0.0, 2.0, 4.0])            # mean 2, var 8/3
    b = torch.tensor([10.0, 10.0, 13.0])         # mean 11, var 2
    x = torch.stack([a, b], dim=1)[:, :, None]   # (3, groups=2, F=1)
    bn = BatchNorm((1,), (-1,), group_axes=(1,)).train()
    y = bn(x)
    assert torch.allclose(y[:, 0, 0], (a - 2) / torch.sqrt(
        torch.tensor(8 / 3 + 1e-5)), atol=1e-6)
    assert torch.allclose(y[:, 1, 0], (b - 11) / torch.sqrt(
        torch.tensor(2 + 1e-5)), atol=1e-6)
    m = 0.1
    mean = (1 - m) * ((1 - m) * 0 + m * 2) + m * 11
    var = (1 - m) * ((1 - m) * 1 + m * 4) + m * 3   # unbiased: x 3/2
    assert abs(bn.running_mean.item() - mean) < 1e-6
    assert abs(bn.running_var.item() - var) < 1e-6


# -- the episode sampler ---------------------------------------------------

def _toy_corpus():
    """3 classes of ragged sizes; each item's cloud encodes (class, item)
    and its image the class."""
    c, m, n, h = 3, 6, 4, 2
    counts = torch.tensor([6, 4, 5], dtype=torch.int32)
    clouds = torch.zeros((c, m, n, 3))
    clouds[..., 0] = torch.arange(c)[:, None, None].float()
    clouds[..., 1] = torch.arange(m)[None, :, None].float()
    images = (torch.arange(c, dtype=torch.uint8)[:, None, None, None, None]
              * 50).expand(c, m, h, h, 3).contiguous()
    return DeviceCorpus(images=images, clouds=clouds, counts=counts,
                        episode_counts=counts.clone())


def test_episode_sampler_semantics():
    corpus = _toy_corpus()
    seen = set()
    for seed in range(20):
        ep = sample_episode(corpus, 3, 1, torch.Generator().manual_seed(seed))
        cls = int(ep["cls"])
        seen.add(cls)
        assert ep["pcs"].shape == (3, 4, 3) and ep["pcq"].shape == (1, 4, 3)
        assert ep["xq"].shape == (1, 2, 2, 3)
        assert ep["xad"].shape == (3, 2, 2, 3)
        assert ep["pcad"].shape == (3, 4, 3) and ep["cls"].dtype == torch.int32
        own = torch.cat([ep["pcs"], ep["pcq"]])[:, 0]
        assert (own[:, 0] == cls).all()                    # class membership
        items = own[:, 1].tolist()
        assert len(set(items)) == 4                  # without replacement
        assert max(items) < corpus.counts[cls]             # valid items only
        ad = ep["pcad"][:, 0]
        keys = {(int(a), int(b)) for a, b in ad[:, :2].tolist()}
        assert len(keys) == 3                              # distinct ad items
        assert all(b < corpus.counts[a] for a, b in keys)
        want = torch.full_like(ep["xq"], cls * 50 * 2 / 255 - 1)
        assert torch.allclose(ep["xq"], want)
    assert seen == {0, 1, 2}
    a = sample_episode(corpus, 3, 1, torch.Generator().manual_seed(7))
    b = sample_episode(corpus, 3, 1, torch.Generator().manual_seed(7))
    assert all(torch.equal(a[k], b[k]) for k in a)          # a seed decides


def test_synthetic_corpus_shapes_and_ranges():
    corpus = synthetic_device_corpus(2, 3, 128, 16, seed=0, device="cpu")
    assert corpus.images.shape == (2, 3, 16, 16, 3)
    assert corpus.images.dtype == torch.uint8
    assert corpus.clouds.shape == (2, 3, 128, 3)
    norms = corpus.clouds.norm(dim=-1)
    assert torch.allclose(norms.amax(dim=-1), torch.ones(2, 3), atol=1e-5)
    assert corpus.counts.tolist() == [3, 3] == corpus.episode_counts.tolist()
    again = synthetic_device_corpus(2, 3, 128, 16, seed=0, device="cpu")
    assert torch.equal(corpus.clouds, again.clouds)
    assert torch.equal(corpus.images, again.images)
