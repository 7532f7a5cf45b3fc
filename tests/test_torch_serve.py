"""The port's serving slice against the JAX package, on the CPU.

One small JAX ``ImgPCProtoNet`` (2 clusters x 2 nodes, 64 points,
bottleneck 256, full VGG16 at 32x32) is initialized once per module, its
BatchNorm running statistics and affine parameters are perturbed away
from 0/1, and its variables cross into the port through
``fpsg_torch.io.bridge``. Inputs and template points are made with numpy
and fed to both sides. Each module (PointNet, VGG16-bn, the decoder with
the JAX node chain both fused and unfused) and the whole slice
(prototype + generate_from_proto, and generate) are compared.

Tolerance: rtol 1e-4, atol 1e-5 x max|ref| — f32 on both sides; the
products are summed in other orders (XLA vs ATen convs and matmuls; the
JAX block 1 runs as a space-to-depth rewrite of the same conv), which
moves the last bits of values that pass through ~20 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpsg_torch.config import FPSGConfig
from fpsg_torch.data.corpus import normalize_images
from fpsg_torch.io.bridge import state_dict_from_jax
from fpsg_torch.models import ImgPCProtoNet as TorchNet
from fpsg_torch.models import build_model
from fpsg_torch.serve import Generator
from fpsg_torch.nn import templates as ttemplates
from fpsg_torch.nn.activations import get_activation
from fpsg_tpu.models.protonet import ImgPCProtoNet as JaxNet
from fpsg_tpu.nn import templates as jtemplates
from fpsg_tpu.nn.activations import get_activation as jax_activation

IMG, NPTS, C, NN, BOTTLENECK = 32, 64, 2, 2, 256
PPN = NPTS // C // NN


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4,
                               atol=1e-5 * float(np.abs(ref).max()))


def _conf(**kw):
    return FPSGConfig(num_clusters=C, num_nodes=NN, num_pts=NPTS,
                      bottleneck_size=BOTTLENECK, **kw)


def _jax_net(fused):
    return JaxNet(num_clusters=C, num_nodes=NN, num_points=NPTS,
                  bottleneck_size=BOTTLENECK, decoder_fused=fused)


def _perturb(variables, rng):
    """Running stats and BN affine away from their init values."""
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

    return {
        "params": jax.tree_util.tree_map_with_path(params,
                                                   variables["params"]),
        "batch_stats": jax.tree_util.tree_map_with_path(
            stats, variables["batch_stats"]),
    }


@pytest.fixture(scope="module")
def world():
    """(JAX variables as numpy, port model on the CPU, inputs)."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    net = _jax_net("off")
    xq = jnp.zeros((2, IMG, IMG, 3))
    pcs = jnp.zeros((3, NPTS, 3))
    v = jax.jit(lambda k: net.init(
        {"params": k, "template": k}, {"xq": xq, "pcs": pcs},
        method=net.generate))(jax.random.PRNGKey(0))
    v = jax.device_get(_perturb(v, rng))
    model = build_model(_conf()).eval()
    model.load_state_dict(state_dict_from_jax(v))
    imgs = rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    inputs = {
        "imgs": imgs,
        "xq": imgs.astype(np.float32) * (2.0 / 255.0) - 1.0,
        "pcs": (0.3 * rng.standard_normal((3, NPTS, 3))).astype(np.float32),
        "tp": rng.uniform(0, 1, (2, C, NN, PPN, 2)).astype(np.float32),
    }
    return v, model, inputs


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_pointnet_matches_jax(world):
    v, model, x = world
    net = _jax_net("off")
    ref = net.apply(v, jnp.asarray(x["pcs"]), False,
                    method=lambda m, p, t: m.pc_encoder(p, t))
    with torch.no_grad():
        got = model.pc_encoder(_t(x["pcs"]))
    assert got.shape == (3, 1024)
    _close(got, ref)


def test_vgg_matches_jax(world):
    v, model, x = world
    net = _jax_net("off")
    ref = net.apply(v, jnp.asarray(x["xq"]), False,
                    method=lambda m, i, t: m.img_encoder(i, t))
    with torch.no_grad():
        got = model.img_encoder(_t(x["xq"]))
    assert got.shape == (2, 512) and got.dtype == torch.float32
    _close(got, ref)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_decoder_matches_jax(world, fused):
    v, model, x = world
    net = _jax_net(fused)
    h = np.random.default_rng(1).standard_normal((2, 1536)).astype(
        np.float32)
    ref = net.apply(v, jnp.asarray(h), False, jnp.asarray(x["tp"]),
                    method=lambda m, hh, t, tp: m.pc_decoder(hh, t, tp))
    with torch.no_grad():
        got = model.pc_decoder(_t(h), _t(x["tp"]))
    assert got.shape == (2, NPTS, 3)
    _close(got, ref)


def test_slice_matches_jax(world):
    """prototype + generate_from_proto, and generate, vs the JAX model."""
    v, model, x = world
    net = _jax_net("off")
    proto_ref = net.apply(v, jnp.asarray(x["pcs"]),
                          method=net.encode_prototype)
    ref = net.apply(v, jnp.asarray(x["xq"]), proto_ref,
                    jnp.asarray(x["tp"]), method=net.generate_from_proto)
    with torch.no_grad():
        proto = model.encode_prototype(_t(x["pcs"]))
        got = model.generate_from_proto(_t(x["xq"]), proto, _t(x["tp"]))
        whole = model.generate({"xq": _t(x["xq"]), "pcs": _t(x["pcs"])},
                               template_points=_t(x["tp"]))
    _close(proto, proto_ref)
    _close(got, ref)
    np.testing.assert_array_equal(whole.numpy(), got.numpy())
    assert np.abs(got.numpy()).max() <= 1.0


def test_generator_serves_the_jax_weights(world):
    """Generator.from_variables + a uint8 call == the JAX model on the
    prescaled images with the generator's own template draw."""
    v, _, x = world
    gen = Generator.from_variables(_conf(seed=3), v, device="cpu")
    tp = gen.model.pc_decoder.template_points(
        2, torch.Generator().manual_seed(3))
    got = gen(x["imgs"], x["pcs"])
    net = _jax_net("off")
    proto = net.apply(v, jnp.asarray(x["pcs"]), method=net.encode_prototype)
    ref = net.apply(v, jnp.asarray(x["xq"]), proto, jnp.asarray(tp.numpy()),
                    method=net.generate_from_proto)
    assert got.shape == (2, NPTS, 3) and got.dtype == np.float32
    _close(got, ref)


def test_uint8_equals_prescaled_float(world):
    _, model, x = world
    g1 = Generator(model, seed=5, device="cpu")
    g2 = Generator(model, seed=5, device="cpu")
    proto = g1.prototype(x["pcs"])
    np.testing.assert_array_equal(
        normalize_images(_t(x["imgs"])).numpy(), x["xq"])
    np.testing.assert_array_equal(g1(x["imgs"], proto=proto),
                                  g2(x["xq"], proto=proto))
    # any integer dtype means pixel bytes
    np.testing.assert_array_equal(g1(x["imgs"].astype(np.int32), proto=proto),
                                  g2(x["imgs"], proto=proto))


def test_same_seed_same_stream(world):
    _, model, x = world
    g1 = Generator(model, seed=7, device="cpu")
    g2 = Generator(model, seed=7, device="cpu")
    proto = g1.prototype(x["pcs"])
    first = g1(x["imgs"], proto=proto)
    np.testing.assert_array_equal(first, g2(x["imgs"], proto=proto))
    second = g1(x["imgs"], proto=proto)
    np.testing.assert_array_equal(second, g2(x["imgs"], proto=proto))
    assert not np.array_equal(first, second)       # the stream advanced


def test_generate_keyed_batch_invariant(world):
    """Row i depends on (image i, proto, seed i) only: bitwise under a
    permutation at one batch size, within float tolerance across batch
    sizes (the CPU conv may pick another algorithm per batch size)."""
    _, model, x = world
    gen = Generator(model, device="cpu")
    proto = gen.prototype(x["pcs"])
    imgs = np.concatenate([x["imgs"], x["imgs"][::-1] // 2])
    seeds = [11, 12, 13, 14]
    batch = gen.generate_keyed(imgs, proto=proto, seeds=seeds)
    perm = [3, 1, 0, 2]
    moved = gen.generate_keyed(imgs[perm], proto=proto,
                               seeds=[seeds[i] for i in perm])
    np.testing.assert_array_equal(moved, batch[perm])
    solo = gen.generate_keyed(imgs[2:3], proto=proto, seeds=seeds[2:3])
    _close(solo[0], batch[2])
    per_item = gen.generate_keyed(imgs, proto=proto.expand(4, -1),
                                  seeds=seeds)
    np.testing.assert_array_equal(per_item, batch)
    with pytest.raises(ValueError, match="seeds"):
        gen.generate_keyed(imgs, proto=proto, seeds=seeds[:3])


def test_stream_equals_per_call(world):
    _, model, x = world
    g1 = Generator(model, seed=9, device="cpu")
    g2 = Generator(model, seed=9, device="cpu")
    proto = g1.prototype(x["pcs"])
    batches = [x["imgs"], x["imgs"][::-1], x["xq"]]
    streamed = list(g1.stream(iter(batches), proto=proto))
    assert len(streamed) == len(batches)
    for got, b in zip(streamed, batches):
        np.testing.assert_array_equal(got, g2(b, proto=proto))


def test_stream_propagates_iterator_error(world):
    _, model, x = world
    gen = Generator(model, device="cpu")
    proto = gen.prototype(x["pcs"])

    def bad():
        yield x["imgs"]
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(gen.stream(bad(), proto=proto))


def test_call_needs_exactly_one_of_clouds_or_proto(world):
    _, model, x = world
    gen = Generator(model, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        gen(x["imgs"])


def test_from_config_is_deterministic_per_seed():
    conf = _conf(seed=4)
    a = TorchNet.from_config(conf, device="cpu").state_dict()
    b = TorchNet.from_config(conf, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["pc_decoder.node_conv1.weight"]
    bound = 1.0 / np.sqrt(w.shape[-2])
    assert float(w.abs().max()) <= bound and float(w.std()) > 0.4 * bound


def test_templates_match_jax():
    """Regular points are numpy copies (equal); random draws have the
    JAX templates' support and normalization."""
    np.testing.assert_array_equal(
        ttemplates.SquareTemplate.get_regular_points(2048),
        jtemplates.SquareTemplate.get_regular_points(2048))
    np.testing.assert_array_equal(ttemplates.icosphere_vertices(2),
                                  jtemplates.icosphere_vertices(2))
    gen = torch.Generator().manual_seed(0)
    sq = ttemplates.get_template("SQUARE").get_random_points((4, 64, 2), gen)
    assert sq.dtype == torch.float32 and 0 <= sq.min() and sq.max() < 1
    sp = ttemplates.get_template("SPHERE").get_random_points((4, 64, 3), gen)
    torch.testing.assert_close(sp.norm(dim=-1), torch.ones(4, 64))
    with pytest.raises(ValueError, match="Invalid template"):
        ttemplates.get_template("CUBE")


@pytest.mark.parametrize("name", ["relu", "sigmoid", "softplus",
                                  "logsigmoid", "tanh", "leaky_relu"])
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    got = get_activation(name)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
