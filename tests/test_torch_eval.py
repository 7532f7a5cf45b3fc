"""The evaluation slice against the JAX package, on the CPU: ``reconstruct``,
the ``metric="emd"`` training loss, the episode samplers, the eval step and
the per-class evaluator.

Size: S = 3 support, Q = 2 query, 32x32 images, 64-point clouds, 2
clusters x 2 nodes, bottleneck 64, f32, ``precise_stats``. The weights are
the JAX initialization with BatchNorm scales, biases and running
statistics drawn at random (``_perturb`` of
``tests/test_torch_train_modules.py``), so eval mode reads non-trivial
running statistics; they reach the port through ``fpsg_torch.io.bridge``.
Inputs and template points come from numpy seeds.

JAX's ``reconstruct`` draws its own template points, so its scores are
rebuilt from its parts with pinned points: ``_encode(train=False)``, the
decoder in eval mode, ``chamfer_distance`` and ``sinkhorn_emd``
(``impl="pallas"``: the K6 Pallas kernel in interpret mode). Tolerances,
with the differences measured at these seeds in brackets:

- reconstructions within 1e-5 of their scale (1.8e-7): f32 through VGG,
  PointNet and the decoder with other summation orders;
- CD rtol 1e-4 (0 at this seed); EMD rtol 1e-3, atol 1e-5, the K6 bound
  of ``tests/test_torch_emd.py``, where the two costs' roundings part at
  eps = 2e-4 (2.4e-5);
- the ``metric="emd"`` training loss rtol 1e-4, the train step's bound
  (``tests/test_torch_train_step.py``: 1e-7 weight noise moves the losses
  by up to 3e-5) (2.1e-5, the query loss), and the running statistics of
  that step rtol 1e-5, atol 1e-5 (``stats_close``) (3.0e-6).

The samplers are checked for their semantics (which items, from which
class, distinct), not their draws: the port's ``torch.Generator`` does not
give JAX's bits. The eval step and the evaluator are checked against the
model's own calls on the same episodes and draws.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpsg_torch.config import FPSGConfig
from fpsg_torch.data.corpus import (
    DeviceCorpus, sample_episode_batch, sequential_episode,
)
from fpsg_torch.io.bridge import state_dict_from_jax
from fpsg_torch.models import build_model
from fpsg_torch.train import (
    episodic_eval, evaluate, make_eval_step, run_sequential,
)
from fpsg_tpu.models import ImgPCProtoNet as JaxNet
from fpsg_tpu.ops.chamfer import chamfer_distance as jax_chamfer
from fpsg_tpu.ops.emd import sinkhorn_emd as jax_emd
from test_torch_train_modules import _perturb, stats_close

S, Q, IMG, NPTS, C, NN, BOTT = 3, 2, 32, 64, 2, 2, 64
PPN = NPTS // C // NN
E = 2


def _conf(**kw):
    return FPSGConfig(num_clusters=C, num_nodes=NN, num_pts=NPTS,
                      bottleneck_size=BOTT, n_shot=S, n_query=Q,
                      intra_recon=True, precise_stats=True, pc_dist="emd",
                      **kw)


def _samples(rng):
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [{"xs": f32(S, IMG, IMG, 3), "xq": f32(Q, IMG, IMG, 3),
             "xad": f32(S, IMG, IMG, 3), "pcs": 0.3 * f32(S, NPTS, 3),
             "pcq": 0.3 * f32(Q, NPTS, 3), "pcad": 0.3 * f32(S, NPTS, 3)}
            for _ in range(E)]


@pytest.fixture(scope="module")
def world():
    """JAX net and variables (numpy), the port model with the same weights
    (in training mode), E episodes and their template points."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(11)
    samples = _samples(rng)
    tp = {"query": rng.uniform(0, 1, (E, Q, C, NN, PPN, 2)).astype(
              np.float32),
          "support": rng.uniform(0, 1, (E, S, C, NN, PPN, 2)).astype(
              np.float32)}
    net = JaxNet(num_clusters=C, num_nodes=NN, num_points=NPTS,
                 bottleneck_size=BOTT, intra_support=True, metric="emd",
                 precise_stats=True, decoder_fused="off")
    v = jax.jit(lambda k0, k1: net.init({"params": k0, "template": k1},
                                        samples[0], True))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    v = jax.device_get(_perturb(jax.device_get(v), rng))
    model = build_model(_conf())
    model.load_state_dict(state_dict_from_jax(v))
    return net, v, model.train(), samples, tp


def _torch(d):
    return {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in d.items()}


def test_reconstruct_matches_jax(world):
    """A batch of E episodes through the port's ``reconstruct`` (called in
    training mode: it must use the running statistics and leave them and
    the mode alone) against JAX's parts, episode by episode."""
    net, v, model, samples, tp = world

    def recon(m, sample, points):
        _, img_zq, _, proto = m._encode(sample, False)
        return m.pc_decoder(jnp.concatenate([img_zq, proto], axis=1), False,
                            points)

    jax_recon = jax.jit(lambda var, sample, points: net.apply(
        var, sample, points, method=recon))

    before = {k: t.clone() for k, t in model.state_dict().items()}
    batch = _torch({k: np.stack([s[k] for s in samples])
                    for k in ("xq", "pcs", "pcq")})
    with torch.no_grad():
        got = model.reconstruct(batch, template_points=torch.from_numpy(
            tp["query"].reshape(E * Q, C, NN, PPN, 2)))
    assert model.training
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k
    assert got["cd_loss"].shape == got["emd_loss"].shape == (E,)
    assert got["syn_pc"].shape == (E, Q, NPTS, 3)
    for e, sample in enumerate(samples):
        syn = jax_recon(v, sample, tp["query"][e])
        ref = np.asarray(syn)
        err = np.abs(got["syn_pc"][e].numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max()
        cd = float(jax_chamfer(syn, sample["pcq"]).sum())
        emd = float(jax_emd(syn, jnp.asarray(sample["pcq"]), reduce="sum",
                            impl="pallas"))
        np.testing.assert_allclose(float(got["cd_loss"][e]), cd, rtol=1e-4)
        np.testing.assert_allclose(float(got["emd_loss"][e]), emd, rtol=1e-3,
                                   atol=1e-5)
    # one episode without the episode axis: scalars, the same scores
    one = model.reconstruct(_torch({k: samples[1][k] for k in
                                    ("xq", "pcs", "pcq")}),
                            template_points=torch.from_numpy(tp["query"][1]))
    assert one["cd_loss"].dim() == 0 and one["syn_pc"].shape == (Q, NPTS, 3)
    torch.testing.assert_close(one["cd_loss"], got["cd_loss"][1],
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(one["emd_loss"], got["emd_loss"][1],
                               rtol=1e-5, atol=0)


def test_emd_training_loss_matches_jax(world):
    """``metric="emd"`` (``--pc_dist emd``): the training loss of one
    episode in training mode, and the running statistics it leaves,
    against JAX's ``loss`` with the same template points."""
    net, v, model, samples, tp = world
    sample = samples[0]
    points = {k: a[0] for k, a in tp.items()}
    out, mut = jax.jit(lambda var: net.apply(
        var, sample, True, points, method="loss",
        mutable=["batch_stats"]))(v)
    twin = build_model(_conf())
    twin.load_state_dict(model.state_dict())
    twin.train()
    got = twin.loss(_torch(sample), _torch(points))
    for key in ("ttl_loss", "query_rec_loss", "support_rec_loss"):
        np.testing.assert_allclose(float(got[key].detach()),
                                   float(out[key]), rtol=1e-4, err_msg=key)
    stats_close(twin, "", jax.device_get(mut["batch_stats"]), atol=1e-5)
    with pytest.raises(ValueError, match="eval mode"):
        twin.loss({k: t[None] for k, t in _torch(sample).items()})


def _id_corpus(counts, eligible=None, m=6):
    """A corpus whose items name themselves: cloud point 0 of (c, i) is
    (c, i, 0) and image pixel (0, 0) of it is 10 c + i."""
    c = len(counts)
    clouds = torch.zeros((c, m, 4, 3))
    images = torch.zeros((c, m, 2, 2, 3), dtype=torch.uint8)
    for ci in range(c):
        for i in range(m):
            clouds[ci, i, :, 0], clouds[ci, i, :, 1] = ci, i
            images[ci, i, 0, 0, 0] = 10 * ci + i
    counts = torch.tensor(counts, dtype=torch.int32)
    ep = counts if eligible is None else counts * torch.tensor(eligible)
    return DeviceCorpus(images=images, clouds=clouds, counts=counts,
                        episode_counts=ep.int(),
                        class_names=tuple(f"k{i}" for i in range(c)))


def _ids(pcs):
    """(..., N, 3) clouds of an id corpus -> (..., 2) (class, item)."""
    return pcs[..., 0, :2].long()


def test_sample_episode_batch_semantics():
    """Classes in proportion to their eligible sizes; support and query
    distinct valid items of the episode's class; ad items distinct valid
    items of the whole corpus; images and clouds of the same items."""
    corpus = _id_corpus([5, 3, 6], eligible=[1, 1, 0])
    gen = torch.Generator().manual_seed(0)
    out = sample_episode_batch(corpus, 2, 1, 400, gen)
    assert out["cls"].shape == (400,) and out["cls"].dtype == torch.int32
    assert out["xq"].shape == (400, 1, 2, 2, 3)
    assert out["pcs"].shape == (400, 2, 4, 3) and out["pcad"].shape == \
        (400, 2, 4, 3)
    freq = torch.bincount(out["cls"].long(), minlength=3).float() / 400
    assert freq[2] == 0 and abs(freq[0] - 5 / 8) < 0.08
    counts = corpus.counts.long()
    for e in range(400):
        c = int(out["cls"][e])
        own = torch.cat([_ids(out["pcs"][e]), _ids(out["pcq"][e])])
        assert (own[:, 0] == c).all() and (own[:, 1] < counts[c]).all()
        assert len(set(own[:, 1].tolist())) == 3
        ad = _ids(out["pcad"][e])
        assert (ad[:, 1] < counts[ad[:, 0]]).all()
        assert len(set(map(tuple, ad.tolist()))) == 2
        pix = (out["xq"][e, 0, 0, 0, 0] + 1) * 255 / 2
        assert round(float(pix)) == 10 * c + int(own[2, 1])


def test_sequential_episode_semantics():
    """The indexed item is the query; the support is distinct items of its
    class without it; the batch form gives the same fields per episode."""
    corpus = _id_corpus([4, 6])
    gen = torch.Generator().manual_seed(1)
    for c, i in [(0, 0), (0, 3), (1, 5)]:
        for _ in range(20):
            out = sequential_episode(corpus, c, i, 3, gen)
            assert out["cls"].dim() == 0 and int(out["cls"]) == c
            assert _ids(out["pcq"]).tolist() == [[c, i]]
            sup = _ids(out["pcs"])
            assert (sup[:, 0] == c).all() and (sup[:, 1] != i).all()
            assert (sup[:, 1] < corpus.counts[c]).all()
            assert len(set(sup[:, 1].tolist())) == 3
            assert len(set(map(tuple, _ids(out["pcad"]).tolist()))) == 3
    out = sequential_episode(corpus, torch.tensor([0, 1]),
                             torch.tensor([2, 4]), 3, gen)
    assert out["cls"].tolist() == [0, 1]
    assert _ids(out["pcq"][:, 0]).tolist() == [[0, 2], [1, 4]]
    assert out["xq"].shape == (2, 1, 2, 2, 3) and out["pcs"].shape == \
        (2, 3, 4, 3)


@pytest.fixture(scope="module")
def small_world():
    """A port model (random init, f32) and a synthetic corpus, on the CPU."""
    from fpsg_torch.data.synthetic import synthetic_device_corpus

    torch.set_num_threads(1)
    conf = _conf(eval_episodes=6, eval_chunk=4, seq_eval_chunk=4)
    model = build_model(conf, torch.Generator().manual_seed(0)).train()
    corpus = synthetic_device_corpus(2, 5, NPTS, IMG, seed=0, device="cpu")
    return conf, model, corpus


@pytest.mark.parametrize("with_emd", [True, False])
def test_eval_step_modes(small_world, with_emd):
    """One call: E episodes sampled, then scored in eval mode under
    ``no_grad``; the same as the model's own call on those episodes with
    the same draws, and the running statistics stay."""
    conf, model, corpus = small_world
    before = {k: t.clone() for k, t in model.state_dict().items()}
    step = make_eval_step(model, S, Q, with_emd=with_emd)
    out = step(corpus, torch.Generator().manual_seed(3), 3)
    gen = torch.Generator().manual_seed(3)
    batch = sample_episode_batch(corpus, S, Q, 3, gen)
    with torch.no_grad():
        if with_emd:
            ref = model.reconstruct(batch, generator=gen)
            keys = {"cd_loss": "cd_loss", "emd_loss": "emd_loss"}
        else:
            model.eval()
            ref = model.loss(batch, generator=gen)
            model.train()
            keys = {"cd_loss": "query_rec_loss",
                    "support_rec_loss": "support_rec_loss"}
    assert set(out) == {*keys, "cls"}
    assert torch.equal(out["cls"], batch["cls"])
    for k, r in keys.items():
        assert out[k].shape == (3,) and not out[k].requires_grad
        assert torch.equal(out[k], ref[r]), k
    assert model.training
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_episodic_eval_chunks(small_world):
    """The largest divisor of the episode count not above the chunk."""
    conf, model, corpus = small_world
    sizes = []

    def step(corp, gen, n):
        sizes.append(n)
        return {"cls": torch.zeros(n, dtype=torch.int32)}

    for n_ep, chunk, want in [(6, 4, [3, 3]), (7, 16, [7]), (12, 5, [4] * 3),
                              (5, 1, [1] * 5)]:
        sizes.clear()
        out = episodic_eval(step, corpus, None, n_ep, chunk)
        assert sizes == want and out["cls"].shape == (n_ep,)


@pytest.mark.parametrize("sequential", [False, True])
def test_evaluate_per_class(small_world, capsys, sequential):
    """Per-class means in sorted order, printed in the reference's line
    format; episodic scores divided by Q, sequential ones (one query each)
    visit every item once in (class, item) order."""
    conf, model, corpus = small_world
    conf = _conf(eval_episodes=6, eval_chunk=4, seq_eval_chunk=4,
                 sequential_eval=sequential)
    res = evaluate(model, corpus, conf, torch.Generator().manual_seed(5))
    lines = capsys.readouterr().out.strip().splitlines()
    pat = re.compile(r"^Class: (\S+) -- Rec CD: (\S+); Rec EMD: (\S+)$")
    names = [pat.match(line).group(1) for line in lines]
    assert names == sorted(res) and set(names) <= set(corpus.class_names)
    for line in lines:
        name, cd, emd = pat.match(line).groups()
        assert float(cd) == res[name]["cd"] and float(emd) == res[name]["emd"]
    gen = torch.Generator().manual_seed(5)
    per = {}
    if sequential:
        seen = []
        for c, i, out in run_sequential(model, corpus, conf, gen):
            seen.append((c, i))
            per.setdefault(corpus.class_names[c], []).append(
                (out["cd"], out["emd"]))
        assert seen == [(c, i) for c in range(2) for i in range(5)]
    else:
        out = episodic_eval(make_eval_step(model, S, Q), corpus, gen, 6, 4)
        for c, cd, emd in zip(out["cls"].tolist(), out["cd_loss"].tolist(),
                              out["emd_loss"].tolist()):
            per.setdefault(corpus.class_names[c], []).append(
                (cd / Q, emd / Q))
    assert sorted(per) == sorted(res)
    for name, vals in per.items():
        np.testing.assert_allclose(
            [res[name]["cd"], res[name]["emd"]],
            np.mean(np.asarray(vals), axis=0), rtol=1e-12)
