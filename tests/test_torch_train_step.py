"""The training slice as a whole against the JAX package, on the CPU.

At ``tests/test_full_step_parity.py``'s size (S = 3 support, Q = 1
query, 32x32 images, 64-point clouds, 2 clusters x 2 nodes, bottleneck
1536, ``intra_support`` and ``precise_stats``), one episode with the same
weights (through ``fpsg_torch.io.bridge``) and the same template points
goes through ``ImgPCProtoNet.loss`` in training mode on both sides. The
weights are the JAX initialization (BatchNorm at scale 1, bias 0, as in
``test_full_step_parity.py``); the running statistics are perturbed, so
that their update is checked from non-trivial values.

At this size the step is ill-conditioned: the query decoder normalizes
one cloud's 16 rows per node, which magnifies rounding noise. 1e-7
relative noise on the weights alone moves the port's own losses by up to
3e-5 and its gradients by up to 7e-4 of their max (2e-2 with BatchNorm
scales drawn from [0.5, 1.5]), so bounds of 1e-5 on the losses and 1e-4
on the gradients would sit below the noise floor. Tolerances, with the
JAX-vs-port differences measured at this seed in brackets:

- losses rtol 1e-4 (ttl 2.6e-7, query 1.5e-5, support 2.4e-6);
- every gradient leaf within 2e-2 of its max (``grads_close`` of
  ``tests/test_torch_train_modules.py``, which also explains its floor for
  cancellation-noise leaves) (worst 6.9e-3, ``node_bn1.bias``). The
  modules on their own agree within 1e-4 (``test_torch_train_modules.py``);
- running statistics rtol 1e-5, atol 1e-5 (worst 3.2e-6 absolute).

Then one Adam step on the same gradients against ``optax.adam``
(elementwise, within 1e-5 of the step size plus 2 ulps: the two compute
the same formula with other roundings), the StepLR schedule against the
JAX one, and the entry points ``init_state`` / ``make_train_step`` on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fpsg_torch.config import FPSGConfig
from fpsg_torch.data.synthetic import synthetic_device_corpus
from fpsg_torch.io.bridge import state_dict_from_jax
from fpsg_torch.models import build_model
from fpsg_torch.train import (
    init_state, make_lr_schedule, make_optimizer, make_train_step,
)
from fpsg_tpu.models import ImgPCProtoNet as JaxNet
from fpsg_tpu.train.optim import make_lr_schedule as jax_lr_schedule
from test_torch_train_modules import _perturb, grads_close, stats_close

LOSS_RTOL, GRAD_TOL, STATS_ATOL = 1e-4, 2e-2, 1e-5

S, Q, IMG, NPTS, C, NN, BOTT = 3, 1, 32, 64, 2, 2, 1536
PPN = NPTS // C // NN


def _conf(**kw):
    return FPSGConfig(num_clusters=C, num_nodes=NN, num_pts=NPTS,
                      bottleneck_size=BOTT, n_shot=S, n_query=Q,
                      intra_recon=True, precise_stats=True, **kw)


@pytest.fixture(scope="module")
def step_world():
    """JAX loss, gradients and updated statistics of one episode, and the
    port model with the same weights after its own loss and backward."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    sample = {"xs": f32(S, IMG, IMG, 3), "xq": f32(Q, IMG, IMG, 3),
              "xad": f32(S, IMG, IMG, 3), "pcs": 0.3 * f32(S, NPTS, 3),
              "pcq": 0.3 * f32(Q, NPTS, 3), "pcad": 0.3 * f32(S, NPTS, 3)}
    tp = {"query": rng.uniform(0, 1, (Q, C, NN, PPN, 2)).astype(np.float32),
          "support": rng.uniform(0, 1, (S, C, NN, PPN, 2)).astype(
              np.float32)}
    net = JaxNet(num_clusters=C, num_nodes=NN, num_points=NPTS,
                 bottleneck_size=BOTT, intra_support=True,
                 precise_stats=True)
    v = jax.jit(lambda k0, k1: net.init({"params": k0, "template": k1},
                                        sample, True))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    v = jax.device_get(v)
    v["batch_stats"] = _perturb(v, rng)["batch_stats"]

    @jax.jit
    def loss_and_grads(variables):
        def f(params):
            out, mut = net.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                sample, True, tp, method="loss", mutable=["batch_stats"])
            return out["ttl_loss"], (out, mut["batch_stats"])

        (_, (out, stats)), grads = jax.value_and_grad(f, has_aux=True)(
            variables["params"])
        return out, grads, stats

    out, grads, stats = jax.device_get(loss_and_grads(v))

    model = build_model(_conf())
    model.load_state_dict(state_dict_from_jax(v))
    model.train()
    t = {k: torch.from_numpy(a) for k, a in sample.items()}
    got = model.loss(t, {k: torch.from_numpy(a) for k, a in tp.items()})
    got["ttl_loss"].backward()
    return {"jax": (v, out, grads, stats), "port": (model, got)}


def test_slice_losses_match_jax(step_world):
    _, out, _, _ = step_world["jax"]
    _, got = step_world["port"]
    for key in ("ttl_loss", "query_rec_loss", "support_rec_loss"):
        np.testing.assert_allclose(float(got[key].detach()),
                                   float(out[key]), rtol=LOSS_RTOL,
                                   err_msg=key)


def test_slice_gradients_match_jax(step_world):
    _, _, grads, _ = step_world["jax"]
    model, _ = step_world["port"]
    grads_close(model, "", grads, tol=GRAD_TOL)


def test_slice_running_stats_match_jax(step_world):
    _, _, _, stats = step_world["jax"]
    model, _ = step_world["port"]
    stats_close(model, "", stats, atol=STATS_ATOL)


def test_one_adam_step_matches_optax(step_world):
    """The port's optimizer and optax.adam take one step from the same
    parameters on the same (JAX) gradients: the new parameters agree
    within 1e-5 of the step size (lr = 1e-3) plus 2 f32 ulps of the
    parameter (the two round the same formula differently: optax in f32,
    torch's bias corrections in f64; measured up to 3.7e-9)."""
    v, _, grads, _ = step_world["jax"]
    tx = optax.adam(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8)

    @jax.jit
    def adam_step(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    ref = state_dict_from_jax(
        {"params": jax.device_get(adam_step(v["params"], grads))})
    model = build_model(_conf())
    model.load_state_dict(state_dict_from_jax(v))
    g = state_dict_from_jax({"params": grads})
    old = {}
    for name, p in model.named_parameters():
        old[name] = p.detach().numpy().copy()
        p.grad = g[name].clone()
    make_optimizer(model.parameters(), lr=1e-3).step()
    for name, p in model.named_parameters():
        new, want = p.detach().numpy(), ref[name].numpy()
        tol = 1e-5 * 1e-3 + 2.4e-7 * np.maximum(np.abs(old[name]),
                                                  np.abs(want))
        assert (np.abs(new - want) <= tol).all(), name


def test_lr_schedule_matches_jax():
    ours = make_lr_schedule(1e-3, 2, 3)
    theirs = jax_lr_schedule(1e-3, 2, 3)
    for step in (0, 5, 6, 11, 12, 40):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-7)
    assert ours(6) == 5e-4 and ours(12) == 2.5e-4


def test_train_step_on_the_cpu():
    """init_state + make_train_step at a tiny size: finite losses, the
    step count and the learning-rate schedule move, parameters and running
    statistics change, folded biases do not."""
    conf = FPSGConfig(num_clusters=2, num_nodes=2, num_pts=64,
                      bottleneck_size=32, n_shot=3, n_query=1,
                      intra_recon=True, precise_stats=True, n_episode=1,
                      lr_decay=1)
    corpus = synthetic_device_corpus(2, 5, 64, 32, device="cpu")
    state = init_state(conf, device="cpu")
    assert state.model.training
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_train_step(conf)
    gen = torch.Generator().manual_seed(3)
    for i in range(2):
        state, metrics = step(state, corpus, gen)
        assert torch.isfinite(metrics["query_rec_loss"])
        assert torch.isfinite(metrics["support_rec_loss"])
        assert int(metrics["cls"]) in (0, 1)
    assert state.step == 2
    assert state.optimizer.param_groups[0]["lr"] == 5e-4   # epoch 1
    after = state.model.state_dict()
    assert not torch.equal(after["pc_decoder.node_conv2.weight"],
                           before["pc_decoder.node_conv2.weight"])
    rv = "img_encoder.encoder.features_1.running_var"
    assert not torch.equal(after[rv], before[rv])
    for name in ("img_encoder.encoder.features_0.bias",
                 "pc_decoder.node_conv1.bias"):
        assert torch.equal(after[name], before[name])


def test_unported_training_modes_raise():
    """E > 1 and a device mesh raise, naming the slice that brings them;
    ``steps_per_call`` and ``bf16_moments`` are ported."""
    for kw in ({"episodes_per_step": 2}, {"dp": 2}, {"mp": 2}):
        conf = FPSGConfig(**{"precise_stats": True, **kw})
        with pytest.raises(NotImplementedError, match="slice 9"):
            make_train_step(conf)
    make_train_step(FPSGConfig(steps_per_call=2, bf16_moments=True))
    with pytest.raises(ValueError):
        make_train_step(FPSGConfig(compute_dtype="f16"))
