"""The training step with single-read BatchNorm statistics, f32 and bf16,
against the JAX package on the CPU.

At ``tests/test_torch_train_step.py``'s size (S = 3 support, Q = 1
query, 32x32 images, 64-point clouds, 2 clusters x 2 nodes, bottleneck
1536, ``intra_support``), one episode with the same weights, perturbed
running statistics and template points goes through ``loss`` and its
backward on both sides. The JAX net runs ``precise_stats=False``,
``decoder_fused="off"``, its K3/K4 Pallas kernels forced on in interpret
mode (``_FORCE_MOMENTS_KERNEL``, ``_FORCE_POOL_KERNEL``); the port runs the
plain versions of its kernels.

- f32: as ``test_torch_train_step.py`` measured for the two-pass step, the
  step is ill-conditioned here: 1e-7 relative noise on the weights moves
  the port's own single-read losses by up to 2.2e-5. Bounds, with the
  JAX-vs-port figures measured at this seed in brackets: losses rtol 1e-4
  (worst 4.5e-5, ``support_rec_loss``); every gradient leaf within 2e-2
  of its max by ``grads_close`` (worst 7.1e-3, ``node_bn1.bias``); running
  statistics rtol 1e-5, atol 1e-5 (worst 5.2e-6 absolute).
- bf16: rounding to bf16 at every layer makes the two frameworks' steps
  differ far more than f32 rounding does: 1e-7 relative noise on the
  weights moves the port's own bf16 losses by up to 1e-1 (the query
  loss), and the deformer's BatchNorm outputs agree bit for bit while
  one-unit differences from the matmuls' summation order spread through
  the node chain. So each bf16 quantity of the port is held to twice the
  reference's own bf16-vs-f32 gap at this seed (the JAX package's; the
  port's own gap would grow with a fault of the port's bf16 path),
  measured in the test from the same runs: the losses (relative; the
  port's distance measured at most 1.18 of that gap, ``ttl_loss``), each
  gradient leaf (relative Frobenius norm; at most 1.64,
  ``deformer_conv3.bias``) and the running statistics (absolute; at most
  1.35, ``node_bn2.running_mean``). The port's own bf16-vs-f32 gap is at
  most 0.46 of the JAX package's on the losses.

Then the entry points ``init_state`` / ``make_train_step`` in bf16 on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpsg_tpu.nn.pointnet as jpn
import fpsg_tpu.nn.vgg as jvgg
from fpsg_torch.config import FPSGConfig
from fpsg_torch.data.synthetic import synthetic_device_corpus
from fpsg_torch.io.bridge import state_dict_from_jax
from fpsg_torch.models import build_model
from fpsg_torch.train import init_state, make_train_step
from fpsg_tpu.models import ImgPCProtoNet as JaxNet
from test_torch_train_modules import _perturb, grads_close, stats_close

LOSS_RTOL, GRAD_TOL, STATS_ATOL = 1e-4, 2e-2, 1e-5
BF16_FACTOR = 2.0
LOSSES = ("ttl_loss", "query_rec_loss", "support_rec_loss")

S, Q, IMG, NPTS, C, NN, BOTT = 3, 1, 32, 64, 2, 2, 1536
PPN = NPTS // C // NN


def _conf(dt, **kw):
    return FPSGConfig(num_clusters=C, num_nodes=NN, num_pts=NPTS,
                      bottleneck_size=BOTT, n_shot=S, n_query=Q,
                      intra_recon=True, compute_dtype=dt, **kw)


@pytest.fixture(scope="module")
def runs():
    """For "f32" and "bf16": the JAX step's (losses, gradient state dict,
    running statistics) and the port's (losses, model after backward)."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    sample = {"xs": f32(S, IMG, IMG, 3), "xq": f32(Q, IMG, IMG, 3),
              "xad": f32(S, IMG, IMG, 3), "pcs": 0.3 * f32(S, NPTS, 3),
              "pcq": 0.3 * f32(Q, NPTS, 3), "pcad": 0.3 * f32(S, NPTS, 3)}
    tp = {"query": rng.uniform(0, 1, (Q, C, NN, PPN, 2)).astype(np.float32),
          "support": rng.uniform(0, 1, (S, C, NN, PPN, 2)).astype(
              np.float32)}
    out = {}
    v = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpn, "_FORCE_MOMENTS_KERNEL", True)
        mp.setattr(jvgg, "_FORCE_POOL_KERNEL", True)
        for dt in ("f32", "bf16"):
            net = JaxNet(num_clusters=C, num_nodes=NN, num_points=NPTS,
                         bottleneck_size=BOTT, intra_support=True,
                         decoder_fused="off",
                         dtype=jnp.bfloat16 if dt == "bf16" else None)
            if v is None:
                v = jax.device_get(jax.jit(
                    lambda k0, k1: net.init({"params": k0, "template": k1},
                                            sample, True))(
                    jax.random.PRNGKey(0), jax.random.PRNGKey(1)))
                v["batch_stats"] = _perturb(v, rng)["batch_stats"]

            @jax.jit
            def loss_and_grads(variables):
                def f(params):
                    o, mut = net.apply(
                        {"params": params,
                         "batch_stats": variables["batch_stats"]},
                        sample, True, tp, method="loss",
                        mutable=["batch_stats"])
                    return o["ttl_loss"], (o, mut["batch_stats"])

                (_, (o, st)), g = jax.value_and_grad(f, has_aux=True)(
                    variables["params"])
                return o, g, st

            o, g, st = jax.device_get(loss_and_grads(v))
            model = build_model(_conf(dt))
            model.load_state_dict(state_dict_from_jax(v))
            model.train()
            got = model.loss({k: torch.from_numpy(a)
                              for k, a in sample.items()},
                             {k: torch.from_numpy(a) for k, a in tp.items()})
            got["ttl_loss"].backward()
            out[dt] = {"jax": ({k: float(o[k]) for k in LOSSES}, g, st),
                       "port": ({k: float(got[k].detach()) for k in LOSSES},
                                model)}
    return out


def test_single_read_f32_step_matches_jax(runs):
    (jl, grads, stats), (pl, model) = runs["f32"]["jax"], runs["f32"]["port"]
    for key in LOSSES:
        np.testing.assert_allclose(pl[key], jl[key], rtol=LOSS_RTOL,
                                   err_msg=key)
    assert not model.img_encoder.encoder.features_4.two_pass
    grads_close(model, "", grads, tol=GRAD_TOL)
    stats_close(model, "", stats, atol=STATS_ATOL)


def _port_grads(model):
    return {n: p.grad.detach() for n, p in model.named_parameters()
            if p.grad is not None}


def _stats(model):
    return {k: t for k, t in model.state_dict().items() if "running" in k}


def _frob(a, b):
    return float((a - b).norm()) / (float(b.norm()) + 1e-30)


def test_single_read_bf16_step_matches_jax(runs):
    """Each quantity within BF16_FACTOR x the JAX package's own
    bf16-vs-f32 gap (module docstring)."""
    jl = {dt: runs[dt]["jax"][0] for dt in runs}
    pl = runs["bf16"]["port"][0]
    for key in LOSSES:
        rel = lambda a, b: abs(a - b) / abs(b)
        gap = rel(jl["bf16"][key], jl["f32"][key])
        assert rel(pl[key], jl["bf16"][key]) <= BF16_FACTOR * gap, key

    jg = {dt: state_dict_from_jax({"params": runs[dt]["jax"][1]})
          for dt in runs}
    pg = _port_grads(runs["bf16"]["port"][1])
    assert pg.keys() == _port_grads(runs["f32"]["port"][1]).keys()
    for name, g in pg.items():
        gap = _frob(jg["bf16"][name], jg["f32"][name])
        assert _frob(g, jg["bf16"][name]) <= BF16_FACTOR * gap, name

    js = {dt: state_dict_from_jax({"batch_stats": runs[dt]["jax"][2]})
          for dt in runs}
    for name, t in _stats(runs["bf16"]["port"][1]).items():
        gap = float((js["bf16"][name] - js["f32"][name]).abs().max())
        err = float((t - js["bf16"][name]).abs().max())
        assert err <= BF16_FACTOR * gap, name


def test_bf16_train_step_on_the_cpu():
    """init_state + make_train_step in bf16 with single-read statistics
    at a tiny size: finite losses, parameters (f32) and running
    statistics move, folded biases do not."""
    conf = FPSGConfig(num_clusters=2, num_nodes=2, num_pts=64,
                      bottleneck_size=32, n_shot=3, n_query=1,
                      intra_recon=True, compute_dtype="bf16", n_episode=1)
    corpus = synthetic_device_corpus(2, 5, 64, 32, device="cpu")
    state = init_state(conf, device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_train_step(conf)
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        state, metrics = step(state, corpus, gen)
        assert metrics["query_rec_loss"].dtype == torch.float32
        assert torch.isfinite(metrics["query_rec_loss"])
        assert torch.isfinite(metrics["support_rec_loss"])
    after = state.model.state_dict()
    assert all(t.dtype == torch.float32 for t in after.values())
    for name in ("pc_decoder.node_conv2.weight",
                 "img_encoder.encoder.features_40.weight",
                 "img_encoder.encoder.features_41.running_var",
                 "pc_encoder.pointnet_feat_extractor.bn3.running_mean"):
        assert not torch.equal(after[name], before[name]), name
    for name in ("img_encoder.encoder.features_0.bias",
                 "pc_decoder.node_conv1.bias"):
        assert torch.equal(after[name], before[name]), name
