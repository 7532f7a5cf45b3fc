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

``bench.py``'s configuration (the decoder's fused node chain, bf16 Adam
moments, ``steps_per_call``) comes from the same JAX runs: the JAX
package's fused and unfused chains are equal by its own
``tests/test_fused_decoder.py``, and a JAX step with the fused chain in
interpret mode would cost another compile. In bf16 the fused chain rounds
at other points than the unfused one (it adds the conditioning in f32
before one rounding, and applies each BatchNorm as an affine in the next
layer's prologue), and the port's fused bf16 decoder gives JAX's fused
bf16 output within 1e-5 of its scale (``tests/test_torch_fused_train.py``).
So, as ``test_fused_bf16_close`` holds JAX's fused chain, each fused
quantity is held to its distance from the JAX f32 step: within twice the
JAX bf16 step's own distance from it (the gap above).

- the port's bf16 model with ``decoder_fused="on"`` on the episode above:
  the losses, every gradient leaf and the running statistics (measured at
  most 1.61 of the gap, ``deformer_conv3.bias``; its distance to JAX's
  unfused bf16 step is 2.12 of the gap there);
- ``make_train_step`` with ``decoder_fused="on"``, ``bf16_moments`` and
  ``steps_per_call=2`` from the same weights: the first step's losses on
  its episode and template points (replayed from the step's generator)
  against JAX's f32 losses there, within twice JAX's bf16-vs-f32 gap on
  that episode (measured at most 0.52 of it); both steps' metrics stacked
  (2,) and finite.

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
from fpsg_torch.data.corpus import sample_episode
from fpsg_torch.data.synthetic import synthetic_device_corpus
from fpsg_torch.io.bridge import state_dict_from_jax
from fpsg_torch.models import build_model
from fpsg_torch.train import init_state, make_train_step
from fpsg_torch.train.optim import CompactAdam
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


def _bench_step(v):
    """Two optimizer steps in one call of ``make_train_step`` at
    ``bench.py``'s configuration (fused chain, bf16 moments,
    ``steps_per_call=2``) from the weights ``v``; the first step's episode
    and template points, replayed from the generator."""
    conf = _conf("bf16", bf16_moments=True, steps_per_call=2)
    corpus = synthetic_device_corpus(2, 5, NPTS, IMG, device="cpu")
    state = init_state(conf, device="cpu")
    state.model.load_state_dict(state_dict_from_jax(v))
    state.model.pc_decoder.fused = "on"
    gen = torch.Generator().manual_seed(11)
    start = gen.get_state()
    state, metrics = make_train_step(conf)(state, corpus, gen)
    gen.set_state(start)
    batch = sample_episode(corpus, S, Q, gen)
    dec = state.model.pc_decoder
    tp = {"query": dec.template_points(Q, gen).numpy(),
          "support": dec.template_points(S, gen).numpy()}
    sample = {k: batch[k].numpy() for k in ("xq", "xad", "pcs", "pcq",
                                            "pcad")}
    sample["xs"] = np.zeros((S, IMG, IMG, 3), np.float32)
    return state, metrics, sample, tp


@pytest.fixture(scope="module")
def runs():
    """For "f32" and "bf16": the JAX step's (losses, gradient state dict,
    running statistics) and the port's (losses, model after backward);
    for "bf16" also the port's with the fused decoder chain; for "bench"
    the port's two steps at bench.py's configuration and JAX's losses on
    the first one's episode in f32 and bf16."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    sample = {"xs": f32(S, IMG, IMG, 3), "xq": f32(Q, IMG, IMG, 3),
              "xad": f32(S, IMG, IMG, 3), "pcs": 0.3 * f32(S, NPTS, 3),
              "pcq": 0.3 * f32(Q, NPTS, 3), "pcad": 0.3 * f32(S, NPTS, 3)}
    tp = {"query": rng.uniform(0, 1, (Q, C, NN, PPN, 2)).astype(np.float32),
          "support": rng.uniform(0, 1, (S, C, NN, PPN, 2)).astype(
              np.float32)}
    out = {"bench": {}}
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
                out["bench"]["port"] = _bench_step(v)

            @jax.jit
            def loss_and_grads(variables, sample, tp):
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

            o, g, st = jax.device_get(loss_and_grads(v, sample, tp))
            _, bench_sample, bench_tp = out["bench"]["port"][1:]
            ob = jax.device_get(loss_and_grads(v, bench_sample,
                                               bench_tp)[0])
            out["bench"][dt] = {k: float(ob[k]) for k in LOSSES}
            out[dt] = {"jax": ({k: float(o[k]) for k in LOSSES}, g, st)}
            for name, fused in (("port", "off"), ("port_fused", "on")):
                if dt == "f32" and fused == "on":
                    continue
                model = build_model(_conf(dt))
                model.load_state_dict(state_dict_from_jax(v))
                model.pc_decoder.fused = fused
                model.train()
                got = model.loss({k: torch.from_numpy(a)
                                  for k, a in sample.items()},
                                 {k: torch.from_numpy(a)
                                  for k, a in tp.items()})
                got["ttl_loss"].backward()
                out[dt][name] = ({k: float(got[k].detach()) for k in LOSSES},
                                 model)
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
    _check_bf16(runs, "port")


def test_fused_decoder_bf16_step_matches_jax(runs):
    """The same with the decoder's fused node chain (bench.py's), each
    quantity's distance from the JAX f32 step within BF16_FACTOR x the
    JAX bf16 step's (module docstring)."""
    _check_bf16(runs, "port_fused", "f32")


def _check_bf16(runs, port, ref="bf16"):
    """The port's bf16 step against JAX's ``ref`` step, each quantity
    within BF16_FACTOR x JAX's bf16-vs-f32 gap."""
    dts = ("f32", "bf16")
    jl = {dt: runs[dt]["jax"][0] for dt in dts}
    pl = runs["bf16"][port][0]
    for key in LOSSES:
        rel = lambda a, b: abs(a - b) / abs(b)
        gap = rel(jl["bf16"][key], jl["f32"][key])
        assert rel(pl[key], jl[ref][key]) <= BF16_FACTOR * gap, key

    jg = {dt: state_dict_from_jax({"params": runs[dt]["jax"][1]})
          for dt in dts}
    model = runs["bf16"][port][1]
    assert model.pc_decoder.fused_chain(torch.zeros(1)) == (
        port == "port_fused")
    pg = _port_grads(model)
    assert pg.keys() == _port_grads(runs["f32"]["port"][1]).keys()
    for name, g in pg.items():
        gap = _frob(jg["bf16"][name], jg["f32"][name])
        assert _frob(g, jg[ref][name]) <= BF16_FACTOR * gap, name

    js = {dt: state_dict_from_jax({"batch_stats": runs[dt]["jax"][2]})
          for dt in dts}
    for name, t in _stats(model).items():
        gap = float((js["bf16"][name] - js["f32"][name]).abs().max())
        err = float((t - js[ref][name]).abs().max())
        assert err <= BF16_FACTOR * gap, name


def test_bench_config_step_matches_jax(runs):
    """``make_train_step`` at bench.py's configuration: the first of two
    steps in one call against JAX on the same episode (module
    docstring)."""
    state, metrics = runs["bench"]["port"][:2]
    assert isinstance(state.optimizer, CompactAdam) and state.step == 2
    assert all(st["exp_avg"].dtype == torch.bfloat16
               for st in state.optimizer.state.values())
    for key in ("query_rec_loss", "support_rec_loss"):
        got = metrics[key]
        assert got.shape == (2,) and torch.isfinite(got).all(), key
        jb, jf = runs["bench"]["bf16"][key], runs["bench"]["f32"][key]
        gap = abs(jb - jf) / abs(jf)
        assert abs(float(got[0]) - jf) / abs(jf) <= BF16_FACTOR * gap, key


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
