"""bf16 Adam moments and ``steps_per_call`` against the JAX package, on the
CPU.

- :class:`fpsg_torch.train.optim.CompactAdam` takes one step from the same
  non-trivial state (parameters, stored bf16 moments, update count 4) on
  the same gradients as ``fpsg_tpu.train.optim.make_optimizer(
  bf16_moments=True)`` (``scale_by_adam_compact`` and the StepLR rate at
  that count). The updates agree within rtol 1e-6 plus 1e-6 of each
  leaf's largest update (the two round the same f32 formula in other
  places: an FMA, or a cancellation in ``b1 mu + (1 - b1) g``); the
  stored moments within one bf16 ulp of JAX's; ``step`` adds exactly
  those updates, and a parameter without a gradient (JAX: an exact 0)
  keeps its value and moments.
- With f32 moment storage it is the f32 Adam path: three steps from zero
  moments give ``torch.optim.Adam``'s parameters within the bound that
  ``tests/test_torch_train_step.py`` holds the f32 Adam to against optax
  (1e-5 of the step size plus 2 f32 ulps of the parameter).
- ``steps_per_call = 3`` through ``make_train_step`` equals three calls of
  one step bit for bit on the CPU (same generator, bf16 moments, bf16
  compute, the decoder's fused chain), with the metrics stacked (3,).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpsg_torch.config import FPSGConfig
from fpsg_torch.data.synthetic import synthetic_device_corpus
from fpsg_torch.train import init_state, make_train_step
from fpsg_torch.train.optim import (
    CompactAdam, make_lr_schedule, make_optimizer,
)
from fpsg_tpu.train.optim import make_optimizer as jax_make_optimizer

SHAPES = {"a": (37, 5), "b": (211,), "c": (3, 4, 6), "frozen": (7,)}
LR, DECAY, EPOCH, COUNT = 1e-3, 1, 2, 4


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


def _as_bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_world():
    """Parameters, gradients (``frozen``: 0), stored bf16 moments; JAX's
    updates and new state after one step from update count COUNT."""
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = {k: (1e-2 * rng.standard_normal(s)).astype(np.float32)
             for k, s in SHAPES.items()}
    grads["frozen"] = np.zeros(SHAPES["frozen"], np.float32)
    mu = {k: _as_bf16(1e-2 * rng.standard_normal(s))
          for k, s in SHAPES.items()}
    nu = {k: _as_bf16(1e-4 * rng.uniform(0.1, 1.0, s))
          for k, s in SHAPES.items()}
    for m in (mu, nu):
        m["frozen"] = np.zeros(SHAPES["frozen"], np.float32)
    tx = jax_make_optimizer(lr=LR, lr_decay_epochs=DECAY,
                            steps_per_epoch=EPOCH, bf16_moments=True)
    adam, sched = tx.init(params)
    state = (adam._replace(
        count=jnp.asarray(COUNT, jnp.int32),
        mu={k: jnp.asarray(v, jnp.bfloat16) for k, v in mu.items()},
        nu={k: jnp.asarray(v, jnp.bfloat16) for k, v in nu.items()}),
        sched._replace(count=jnp.asarray(COUNT, jnp.int32)))
    upd, new_state = jax.device_get(jax.jit(tx.update)(grads, state,
                                                       params))
    return params, grads, mu, nu, upd, new_state[0]


def _compact_world():
    """The port's optimizer in the state of :func:`_jax_world` (no gradient
    for ``frozen``) and JAX's results."""
    params, grads, mu, nu, upd, adam = _jax_world()
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    lr = make_lr_schedule(LR, DECAY, EPOCH)(COUNT)
    assert lr == LR / 4
    opt = CompactAdam(ps.values(), lr=lr)
    opt.param_groups[0]["count"] = COUNT
    for k, p in ps.items():
        opt.state[p]["exp_avg"] = torch.from_numpy(mu[k]).bfloat16()
        opt.state[p]["exp_avg_sq"] = torch.from_numpy(nu[k]).bfloat16()
        p.grad = None if k == "frozen" else torch.from_numpy(grads[k])
    return params, ps, opt, upd, adam


def test_bf16_moment_step_matches_scale_by_adam_compact():
    _, ps, opt, upd, adam = _compact_world()
    got = opt.updates(opt.param_groups[0])
    assert opt.param_groups[0]["count"] == COUNT + 1
    keys = [k for k in SHAPES if k != "frozen"]
    assert len(got) == len(keys) and not np.asarray(upd["frozen"]).any()
    for k, u in zip(keys, got):
        want = np.asarray(upd[k])
        np.testing.assert_allclose(u.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=k)
        for name, ref in (("exp_avg", adam.mu[k]),
                          ("exp_avg_sq", adam.nu[k])):
            mine = opt.state[ps[k]][name]
            assert mine.dtype == torch.bfloat16
            ref = np.asarray(jnp.asarray(ref, jnp.float32))
            assert (np.abs(mine.float().numpy() - ref)
                    <= _bf16_ulp(ref)).all(), (k, name)


def test_bf16_moment_step_applies_the_updates():
    """``step`` adds the updates to the parameters with gradients and
    leaves a parameter without one, and its moments, unchanged."""
    params, ps, opt, _, _ = _compact_world()
    _, twin, twin_opt, _, _ = _compact_world()
    upd = twin_opt.updates(twin_opt.param_groups[0])
    opt.step()
    keys = [k for k in SHAPES if k != "frozen"]
    for k, u in zip(keys, upd):
        assert torch.equal(ps[k].detach(), torch.from_numpy(params[k]) + u)
    assert torch.equal(ps["frozen"].detach(),
                       torch.from_numpy(params["frozen"]))
    assert not opt.state[ps["frozen"]]["exp_avg"].float().any()


def test_f32_moments_are_the_f32_adam_path():
    """One step from the same f32 moments at update count COUNT."""
    rng = np.random.default_rng(2)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    a = [torch.nn.Parameter(torch.from_numpy(v.copy()))
         for v in init.values()]
    b = [torch.nn.Parameter(torch.from_numpy(v.copy()))
         for v in init.values()]
    compact = CompactAdam(a, lr=LR, moment_dtype=torch.float32)
    ref = make_optimizer(b, lr=LR)
    assert isinstance(ref, torch.optim.Adam)
    assert isinstance(make_optimizer(a, LR, bf16_moments=True), CompactAdam)
    compact.param_groups[0]["count"] = COUNT
    for pa, pb in zip(a, b):
        m = torch.from_numpy(
            (1e-2 * rng.standard_normal(pa.shape)).astype(np.float32))
        v = torch.from_numpy(
            (1e-4 * rng.uniform(0.1, 1, pa.shape)).astype(np.float32))
        compact.state[pa].update(exp_avg=m.clone(), exp_avg_sq=v.clone())
        ref.state[pb].update(step=torch.tensor(float(COUNT)),
                             exp_avg=m.clone(), exp_avg_sq=v.clone())
        g = torch.from_numpy(
            (1e-2 * rng.standard_normal(pa.shape)).astype(np.float32))
        pa.grad, pb.grad = g, g.clone()
    compact.step()
    ref.step()
    for pa, pb in zip(a, b):
        for key in ("exp_avg", "exp_avg_sq"):
            mine = compact.state[pa][key]
            assert mine.dtype == torch.float32
            torch.testing.assert_close(mine, ref.state[pb][key], rtol=1e-6,
                                       atol=0)
        tol = 1e-5 * LR + 2.4e-7 * pb.detach().abs()
        assert ((pa - pb).detach().abs() <= tol).all()


def _tiny_conf(**kw):
    return FPSGConfig(num_clusters=2, num_nodes=2, num_pts=64,
                      bottleneck_size=32, n_shot=3, n_query=1,
                      intra_recon=True, compute_dtype="bf16",
                      bf16_moments=True, n_episode=2, lr_decay=1, **kw)


def _run(conf, calls):
    corpus = synthetic_device_corpus(2, 5, 64, 32, device="cpu")
    state = init_state(conf, device="cpu")
    state.model.pc_decoder.fused = "on"
    gen = torch.Generator().manual_seed(3)
    step = make_train_step(conf)
    return state, [step(state, corpus, gen)[1] for _ in range(calls)]


def test_steps_per_call_equals_separate_calls():
    fused, (m3,) = _run(_tiny_conf(steps_per_call=3), 1)
    single, ms = _run(_tiny_conf(), 3)
    assert fused.step == single.step == 3
    assert isinstance(fused.optimizer, CompactAdam)
    for key in ("query_rec_loss", "support_rec_loss", "cls"):
        assert m3[key].shape == (3,), key
        assert torch.equal(m3[key], torch.stack([m[key] for m in ms])), key
    sa, sb = fused.model.state_dict(), single.model.state_dict()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    for pa, pb in zip(fused.model.parameters(), single.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            if pa in fused.optimizer.state:
                assert torch.equal(fused.optimizer.state[pa][key],
                                   single.optimizer.state[pb][key])
    assert fused.optimizer.param_groups[0]["lr"] == 5e-4    # epoch 1


@pytest.mark.parametrize("kw,match", [
    ({"episodes_per_step": 2}, "slice 9"),
    ({"dp": 2}, "slice 9"),
    ({"mp": 2}, "slice 9"),
])
def test_modes_of_later_slices_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        make_train_step(_tiny_conf(**kw))
