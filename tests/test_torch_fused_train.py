"""The decoder's fused node chain in training against the JAX package.

At ``tests/test_fused_decoder.py``'s size (2 clusters x 2 nodes, 64
points, bottleneck 64: node widths 67 -> 67 -> 33 -> 16 -> 3, 16 points a
node):

- each fused layer (K5d/K5a with and without ``with_stats``, K5f) and its
  backward (K5e, K5b + K5c, K5g), f32, at B = 3 and B = 1: the port's plain
  forward and plain backward against ``_fused_{l1,mid,out}_fwd`` and
  ``_fused_{l1,mid,out}_bwd_impl`` of ``fpsg_tpu/nn/fused_stack.py``
  (Pallas in interpret mode), fed the same numpy inputs, the same
  residuals and the same cotangents (``gy``, ``gzs``, ``gzq``, ``gzc``).
  Each output within rtol 1e-5 and atol 1e-6 of its scale (max |ref|):
  the same f32 products summed in another order. At B = 3 a second case
  of the mid (with statistics) and output layers puts the relu's input
  exactly at 0 on a grid of values, where the mask is strict.
  The autograd ``Function`` s give the plain backward's values.
- the training decoder with ``fused="on"`` against JAX's
  ``PrimitiveDecoder(fused="on")``: output, running statistics and every
  parameter gradient under one loss, one ``value_and_grad`` per batch
  size. Tolerances are ``test_fused_decoder.py``'s, rtol 1e-4, atol 1e-5
  for the running statistics and rtol 2e-3, atol 2e-4 x the leaf's scale
  for the gradients, except the output: atol 5e-5 of its scale, as
  ``test_torch_train_modules.py`` holds the unfused decoder. Measured at
  this seed: the port's fused output is 2.9e-5 from JAX's, its unfused
  output 2.9e-5 as well, and 1e-7 relative noise on the weights moves the
  port's own output by up to 3.3e-5 (node_bn1 normalizes channels that
  are nearly constant over a cloud's points). In bf16 the port's fused
  output is held to JAX's fused bf16 output within 1e-5 of its scale (the
  same roundings), and, as ``test_fused_bf16_close`` holds JAX's, to be as
  close to the f32 output as the unfused bf16 chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpsg_torch.io.bridge import state_dict_from_jax
from fpsg_torch.nn import fused_stack as tfs
from fpsg_torch.nn.decoder import PrimitiveDecoder
from fpsg_tpu.nn import PrimitiveDecoder as JaxDecoder
from fpsg_tpu.nn import fused_stack as jfs

C, NN, P, BOTT, NPTS = 2, 2, 16, 64, 64
D0 = BOTT + 3                                 # 67 -> 67 -> 33 -> 16 -> 3


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _close(got, ref, name, rtol=1e-5, atol=1e-6):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * max(float(np.abs(ref).max()),
                                               1e-30), err_msg=name)


def _affine(rng, din, ties):
    if ties:     # k = 1, b = -0.25 on a 0.25 grid: pre is exactly 0 often
        return (np.ones((C, NN, din), np.float32),
                np.full((C, NN, din), -0.25, np.float32))
    return (rng.uniform(0.5, 1.5, (C, NN, din)).astype(np.float32),
            _f32(rng, C, NN, din, scale=0.3))


def _rows(rng, r, d, ties):
    x = _f32(rng, C, NN, r, d)
    return np.round(x * 4) / 4 if ties else x


def _grads(fn, inputs, outs_cots):
    """The autograd Function's gradients of ``inputs`` under the
    cotangents of its outputs."""
    ins = [_t(a).requires_grad_() for a in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, ins, [_t(c) for c in outs_cots],
                               allow_unused=True)


CASES = [(b, st) for b in (3, 1) for st in (False, True)]


@pytest.mark.parametrize("batch,with_stats", CASES)
def test_mid_layer_and_backward_match_pallas(batch, with_stats):
    rng = np.random.default_rng(10 + batch)
    r, din, dout = batch * P, D0, D0 // 2
    for ties in (False, True) if batch == 3 and with_stats else (False,):
        yp = _rows(rng, r, din, ties)
        k, b = _affine(rng, din, ties)
        w = _f32(rng, C, NN, din, dout, scale=din ** -0.5)
        s = _f32(rng, C, NN, dout, scale=0.3)
        y, zs, zq = jfs._fused_mid_fwd(yp, k, b, w, s, with_stats, P)
        got = tfs.fused_mid_plain(_t(yp), _t(k), _t(b), _t(w),
                                  _t(s) if with_stats else None)
        got = got if with_stats else (got,)
        for name, g, ref in zip(("y", "zsum", "zsq"), got, (y, zs, zq)):
            _close(g, ref, f"{name} ties={ties}")
        gy = _f32(rng, C, NN, r, dout)
        gzs, gzq = _f32(rng, C, NN, dout), _f32(rng, C, NN, dout, scale=0.1)
        ref = jfs._fused_mid_bwd_impl(yp, k, b, w, s, y, gy, gzs, gzq,
                                      with_stats, P)
        ts = _t(s) if with_stats else None
        tgz = (_t(gzs), _t(gzq)) if with_stats else (None, None)
        args = (_t(yp), _t(k), _t(b), _t(w), ts, _t(np.asarray(y)), _t(gy),
                *tgz)
        dyp, dk, db = tfs.fused_mid_dx_plain(*args)
        dw = tfs.fused_mid_dw_plain(*args[:3], *args[4:], torch.float32)
        for name, g, rf in zip(("dyp", "dk", "db", "dw"),
                               (dyp, dk, db, dw), ref):
            _close(g, rf, f"{name} ties={ties}")
        if ties:
            assert (yp == 0.25).any()
        # the autograd Function: the plain backward at its own forward
        fn = lambda *x: tfs.fused_mid_layer(
            *x, s=ts, with_stats=with_stats)
        own = (*args[:5], fn(*args[:4])[0] if with_stats
               else fn(*args[:4]), *args[6:])
        want = (*tfs.fused_mid_dx_plain(*own),
                tfs.fused_mid_dw_plain(*own[:3], *own[4:], torch.float32))
        cots = (gy, gzs, gzq) if with_stats else (gy,)
        for name, g, w_ in zip(("dyp", "dk", "db", "dw"),
                               _grads(fn, (yp, k, b, w), cots), want):
            assert torch.equal(g, w_), name


@pytest.mark.parametrize("batch,with_stats", CASES)
def test_l1_layer_and_backward_match_pallas(batch, with_stats):
    rng = np.random.default_rng(20 + batch)
    r, dout = batch * P, D0
    d = np.tanh(_f32(rng, C, NN, r, 3))
    wd = _f32(rng, C, NN, 3, dout, scale=0.5)
    yc = _f32(rng, C, NN, batch, dout, scale=2.0)
    sc = yc - yc.mean(axis=2, keepdims=True)
    pad = lambda a, ax: np.pad(a, [(0, 0)] * ax + [(0, 5)]
                               + [(0, 0)] * (3 - ax))
    dpad, wpad = pad(d, 3), pad(wd, 2)
    y, zs, zq, zc = jfs._fused_l1_fwd(dpad, wpad, yc, sc, with_stats, P)
    got = tfs.fused_l1_plain(_t(d), _t(wd), _t(yc), P,
                             _t(sc) if with_stats else None)
    got = got if with_stats else (got,)
    for name, g, ref in zip(("y", "zsum", "zsq", "zcov"), got,
                            (y, zs, zq, zc)):
        _close(g, ref, name)
    gy = _f32(rng, C, NN, r, dout)
    gzs, gzq, gzc = (_f32(rng, C, NN, dout, scale=sc_)
                     for sc_ in (1.0, 0.1, 0.5))
    dd, dwd, dyc, dsc = jfs._fused_l1_bwd_impl(
        dpad, wpad, yc, sc, y, gy, gzs, gzq, gzc, with_stats, P)
    st = (_t(sc), _t(gzs), _t(gzq), _t(gzc)) if with_stats else \
        (None,) * 4
    mine = tfs.fused_l1_bwd_plain(_t(d), _t(wd), _t(yc), st[0],
                                  _t(np.asarray(y)), _t(gy), *st[1:], P)
    refs = (np.asarray(dd)[..., :3], np.asarray(dwd)[:, :, :3], dyc, dsc)
    names = ("dd", "dwd", "dy_cond", "dsc")
    for name, g, ref in zip(names, mine, refs):
        if g is None:
            assert not with_stats and not np.asarray(ref).any(), name
            continue
        _close(g, ref, name)
    # the autograd Function: the plain backward at its own forward
    fn = lambda dd_, wd_, yc_, sc_=None: tfs.fused_l1_layer(
        dd_, wd_, yc_, P, sc=sc_, with_stats=with_stats)
    y_own = got[0].detach()
    want = tfs.fused_l1_bwd_plain(_t(d), _t(wd), _t(yc), st[0], y_own,
                                  _t(gy), *st[1:], P)
    inputs = (d, wd, yc) + ((sc,) if with_stats else ())
    cots = (gy, gzs, gzq, gzc) if with_stats else (gy,)
    for name, g, w_ in zip(names, _grads(fn, inputs, cots), want):
        assert torch.equal(g, w_), name


@pytest.mark.parametrize("batch", [3, 1])
def test_out_layer_and_backward_match_pallas(batch):
    rng = np.random.default_rng(30 + batch)
    r, din = batch * P, D0 // 4
    for ties in (False, True) if batch == 3 else (False,):
        yp = _rows(rng, r, din, ties)
        k, b = _affine(rng, din, ties)
        w = _f32(rng, C, NN, din, 3, scale=din ** -0.5)
        bias = _f32(rng, C, NN, 3, scale=0.1)
        wpad = np.pad(w, [(0, 0)] * 3 + [(0, 5)])
        bpad = np.pad(bias, [(0, 0)] * 2 + [(0, 5)])
        y = jfs._fused_out_fwd(yp, k, b, wpad, bpad, P)
        _close(tfs.fused_out_plain(_t(yp), _t(k), _t(b), _t(w), _t(bias)),
               np.asarray(y)[..., :3], f"y ties={ties}")
        gy = _f32(rng, C, NN, r, 3)
        ref = jfs._fused_out_bwd_impl(yp, k, b, wpad, bpad, y,
                                      np.pad(gy, [(0, 0)] * 3 + [(0, 5)]), P)
        ref = (*ref[:3], np.asarray(ref[3])[..., :3],
               np.asarray(ref[4])[..., :3])
        mine = tfs.fused_out_bwd_plain(_t(yp), _t(k), _t(b), _t(w),
                                       _t(np.asarray(y)[..., :3]), _t(gy))
        names = ("dyp", "dk", "db", "dw", "dbias")
        for name, g, rf in zip(names, mine, ref):
            _close(g, rf, f"{name} ties={ties}")
        # the autograd Function: the plain backward at its own forward
        args = (_t(yp), _t(k), _t(b), _t(w))
        want = tfs.fused_out_bwd_plain(
            *args, tfs.fused_out_plain(*args, _t(bias)), _t(gy))
        grads = _grads(tfs.fused_out_layer, (yp, k, b, w, bias), (gy,))
        for name, g, w_ in zip(names, grads, want):
            assert torch.equal(g, w_), name


# -- the whole training decoder ----------------------------------------------

def _decoder_sd(v):
    sd = state_dict_from_jax({"params": {"pc_decoder": v["params"]},
                              "batch_stats": {"pc_decoder":
                                              v["batch_stats"]}})
    return {k[len("pc_decoder."):]: t for k, t in sd.items()}


def _perturb_stats(v, rng):
    """Running means off 0 and variances off 1, BN scales off 1."""
    def stats(path, a):
        a = np.asarray(a)
        if path[-1].key == "mean":
            return _f32(rng, *a.shape, scale=0.1)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    def params(path, a):
        a = np.asarray(a)
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    return {"params": jax.tree_util.tree_map_with_path(params, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stats, v["batch_stats"])}


@pytest.fixture(scope="module")
def decoders():
    """JAX's fused decoder's (output, running statistics, gradients) under
    one loss at B = 3 and B = 1, its bf16 output at B = 3, and the
    inputs."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(5)
    kw = dict(num_clusters=C, num_nodes=NN, num_points=NPTS,
              bottleneck_size=BOTT)
    fused = JaxDecoder(fused="on", **kw)
    h3 = _f32(rng, 3, BOTT, scale=2.0)
    v = fused.init({"params": jax.random.PRNGKey(0),
                    "template": jax.random.PRNGKey(1)}, h3, True)
    v = jax.device_get(_perturb_stats(jax.device_get(v), rng))
    out = {"v": v}
    for batch in (3, 1):
        h = h3 if batch == 3 else _f32(rng, 1, BOTT, scale=2.0)
        tp = rng.uniform(0, 1, (batch, C, NN, P, 2)).astype(np.float32)
        tgt = _f32(rng, batch, NPTS, 3, scale=0.5)

        def loss(params, h=h, tp=tp, tgt=tgt):
            y, mut = fused.apply({"params": params,
                                  "batch_stats": v["batch_stats"]}, h, True,
                                 tp, mutable=["batch_stats"])
            return jnp.mean((y - tgt) ** 2), (y, mut["batch_stats"])

        (_, (y, st)), g = jax.device_get(jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v["params"]))
        out[batch] = dict(h=h, tp=tp, tgt=tgt, y=np.asarray(y), stats=st,
                          grads=g)
    fused16 = JaxDecoder(fused="on", dtype=jnp.bfloat16, **kw)
    y16, _ = jax.jit(lambda p: fused16.apply(
        {"params": p, "batch_stats": v["batch_stats"]}, h3, True,
        out[3]["tp"], mutable=["batch_stats"]))(v["params"])
    out["fused_bf16_y"] = np.asarray(y16)
    return out


def _port_decoder(v, dtype=None):
    dec = PrimitiveDecoder(num_clusters=C, num_nodes=NN, num_points=NPTS,
                           bottleneck_size=BOTT, d_cond=BOTT, dtype=dtype,
                           fused="on")
    dec.load_state_dict(_decoder_sd(v))
    return dec.train()


@pytest.mark.parametrize("batch", [3, 1])
def test_fused_training_decoder_matches_jax(decoders, batch):
    ref = decoders[batch]
    dec = _port_decoder(decoders["v"])
    assert dec.fused_chain(_t(ref["h"]))
    y = dec(_t(ref["h"]), _t(ref["tp"]))
    torch.mean((y - _t(ref["tgt"])) ** 2).backward()
    scale = float(np.abs(ref["y"]).max())
    np.testing.assert_allclose(y.detach().numpy(), ref["y"], rtol=1e-4,
                               atol=5e-5 * scale)
    want_stats = _decoder_sd({"params": {}, "batch_stats": ref["stats"]})
    sd = dec.state_dict()
    for name, t in want_stats.items():
        np.testing.assert_allclose(sd[name].numpy(), t.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    want = _decoder_sd({"params": ref["grads"], "batch_stats": {}})
    for name, p in dec.named_parameters():
        r = want[name].numpy()
        if p.grad is None:          # a bias folded into a BatchNorm
            assert not r.any(), name
            continue
        scale = max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=2e-3,
                                   atol=2e-4 * scale, err_msg=name)


def test_fused_training_decoder_bf16_close(decoders):
    """bf16: the port's fused chain rounds where JAX's does (its output
    within 1e-5 of the scale of JAX's fused bf16 output), and is as close
    to the f32 output as the unfused bf16 chain (``test_fused_bf16_close``'s
    bound, with the port's unfused chain)."""
    ref = decoders[3]
    ys = {}
    for fused in ("on", "off"):
        dec = _port_decoder(decoders["v"], torch.bfloat16)
        dec.fused = fused
        with torch.no_grad():
            ys[fused] = dec(_t(ref["h"]), _t(ref["tp"])).numpy()
    y = ys["on"]
    assert y.dtype == np.float32 and np.isfinite(y).all()
    want = decoders["fused_bf16_y"]
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    err_u = float(np.abs(ys["off"] - ref["y"]).max())
    err_f = float(np.abs(y - ref["y"]).max())
    assert err_f < max(3.0 * err_u, 0.05), (err_f, err_u)


def test_fused_chain_choice():
    """``auto`` fuses on the card with single-read statistics only; the
    CPU takes the unfused chain unless asked."""
    h = torch.zeros(1, 8)
    kw = dict(num_clusters=1, num_nodes=1, num_points=16,
              bottleneck_size=8, d_cond=8)
    assert not PrimitiveDecoder(**kw).fused_chain(h)
    assert PrimitiveDecoder(fused="on", **kw).fused_chain(h)
    assert not PrimitiveDecoder(fused="off", **kw).fused_chain(h)
    with pytest.raises(ValueError):
        PrimitiveDecoder(fused="yes", **kw)
