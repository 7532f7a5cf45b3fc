"""Evaluation: per-class reconstruction CD and EMD of a model on a corpus
(counterpart of ``fpsg_tpu/train/step.py:make_eval_step`` and of
``fpsg_tpu/train/loop.py``'s ``_run_sequential``, ``_episodic_eval`` and
``evaluate_network``).

    model = ImgPCProtoNet.from_config(conf)          # or trained weights
    gen = torch.Generator(device="cuda").manual_seed(conf.seed)
    results = evaluate(model, corpus, conf, gen)     # {class: {cd, emd}}

- :func:`make_eval_step`: one call scores a batch of E episodes sampled on
  the corpus's device, in eval mode under ``torch.no_grad()``: with EMD
  through :meth:`ImgPCProtoNet.reconstruct` (the evaluator), else the
  loss in eval mode (the trainer's in-loop eval). All E x Q clouds of a
  call go through one Chamfer and one Sinkhorn solve.
- :func:`episodic_eval`: ``n_episodes`` random episodes in equal chunks,
  the largest divisor of ``n_episodes`` not above ``eval_chunk``.
- :func:`run_sequential`: every item once as the query
  (:func:`~fpsg_torch.data.corpus.sequential_episode`),
  ``seq_eval_chunk`` items a call. The JAX package pads the last chunk to
  its compiled size and drops the padded outputs; eager PyTorch has no
  compiled shape to keep, so the last chunk runs at its own size.
- :func:`evaluate`: the in-memory core of ``evaluate_network``
  (``loop.py:696-760``): per-class means, printed in the reference's
  line format (``evaluate_Network.py:122``).

Randomness comes from one ``torch.Generator`` drawn in order (episodes,
then template points), not from split JAX keys: results depend on the
seed and on the chunking, as the JAX package's do on its key splits.
Reading a checkpoint and a corpus from disk, ``dump_reconstructions`` and
the figures of ``utils/visualization.py`` wait for the drivers' slice.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Callable, Dict, Iterator, Tuple

import torch

from fpsg_torch.config import FPSGConfig
from fpsg_torch.data.corpus import (
    DeviceCorpus, sample_episode_batch, sequential_episode,
)
from fpsg_torch.models.protonet import ImgPCProtoNet

Scores = Dict[str, torch.Tensor]


def _score(model: ImgPCProtoNet, sample: Dict[str, torch.Tensor],
           generator: torch.Generator, with_emd: bool) -> Scores:
    """Per-episode scores of a batch of episodes, in eval mode."""
    with torch.no_grad():
        if with_emd:
            out = model.reconstruct(sample, generator=generator)
            return {"cd_loss": out["cd_loss"], "emd_loss": out["emd_loss"]}
        was_training = model.training
        model.eval()
        try:
            out = model.loss(sample, generator=generator)
        finally:
            model.train(was_training)
        return {"cd_loss": out["query_rec_loss"],
                "support_rec_loss": out["support_rec_loss"]}


def make_eval_step(model: ImgPCProtoNet, n_support: int, n_query: int,
                   with_emd: bool = True
                   ) -> Callable[[DeviceCorpus, torch.Generator, int], Scores]:
    """``eval_step(corpus, generator, n_episodes) -> scores``: per episode
    (E,) ``cd_loss`` and ``emd_loss`` (``with_emd``) or ``cd_loss`` and
    ``support_rec_loss`` (the loss in eval mode), and the episodes'
    classes ``cls``; device tensors, nothing waits for the device."""

    def eval_step(corpus: DeviceCorpus, generator: torch.Generator,
                  n_episodes: int) -> Scores:
        batch = sample_episode_batch(corpus, n_support, n_query, n_episodes,
                                     generator)
        out = _score(model, batch, generator, with_emd)
        out["cls"] = batch["cls"]
        return out

    return eval_step


def episodic_eval(eval_step, corpus: DeviceCorpus,
                  generator: torch.Generator, n_episodes: int,
                  max_chunk: int) -> Scores:
    """``n_episodes`` episodes in calls of the largest divisor of
    ``n_episodes`` that is at most ``max_chunk``; the scores concatenated
    (on the device)."""
    chunk = max(d for d in range(1, max(min(max_chunk, n_episodes), 1) + 1)
                if n_episodes % d == 0)
    outs = [eval_step(corpus, generator, chunk)
            for _ in range(n_episodes // chunk)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def run_sequential(model: ImgPCProtoNet, corpus: DeviceCorpus,
                   conf: FPSGConfig, generator: torch.Generator,
                   with_emd: bool = True
                   ) -> Iterator[Tuple[int, int, Dict[str, float]]]:
    """Every item of the corpus once as the query, ``conf.seq_eval_chunk``
    items a call. Yields ``(cls, item, scores)`` in (cls, item) order,
    ``scores`` with ``cd`` (and ``emd`` with ``with_emd``) as floats (one
    host read a call)."""
    chunk = max(1, int(conf.seq_eval_chunk))
    dev = corpus.images.device
    counts = corpus.counts.tolist()
    pairs = [(c, i) for c in range(len(counts)) for i in range(counts[c])]
    for off in range(0, len(pairs), chunk):
        part = pairs[off:off + chunk]
        sample = sequential_episode(
            corpus, torch.tensor([p[0] for p in part], device=dev),
            torch.tensor([p[1] for p in part], device=dev), conf.n_shot,
            generator)
        out = _score(model, sample, generator, with_emd)
        host = {"cd": out["cd_loss"].tolist()}
        if with_emd:
            host["emd"] = out["emd_loss"].tolist()
        for j, (c, i) in enumerate(part):
            yield c, i, {k: v[j] for k, v in host.items()}


def evaluate(model: ImgPCProtoNet, corpus: DeviceCorpus, conf: FPSGConfig,
             generator: torch.Generator) -> Dict[str, Dict[str, float]]:
    """Per-class mean reconstruction CD and EMD: sequential
    (``conf.sequential_eval``: every item once, one query each) or over
    ``conf.eval_episodes`` random episodes of ``conf.n_shot`` support and
    ``conf.effective_n_query`` query items in chunks of at most
    ``conf.eval_chunk``, each episode's sums divided by its query count.
    Prints ``Class: {name} -- Rec CD: {cd}; Rec EMD: {emd}`` per class, in
    sorted order, and returns ``{name: {"cd": ..., "emd": ...}}``."""
    per_cd, per_emd = defaultdict(list), defaultdict(list)
    if conf.sequential_eval:
        # one query per episode: the per-query normalization divides by 1
        for c, _, out in run_sequential(model, corpus, conf, generator):
            name = corpus.class_names[c]
            per_cd[name].append(out["cd"])
            per_emd[name].append(out["emd"])
    else:
        n_query = conf.effective_n_query
        step = make_eval_step(model, conf.n_shot, n_query, with_emd=True)
        out = episodic_eval(step, corpus, generator, conf.eval_episodes,
                            conf.eval_chunk)
        for c, cd, emd in zip(out["cls"].tolist(), out["cd_loss"].tolist(),
                              out["emd_loss"].tolist()):
            name = corpus.class_names[c]
            per_cd[name].append(cd / n_query)
            per_emd[name].append(emd / n_query)
    results = {}
    for name in sorted(per_cd):
        results[name] = {"cd": statistics.mean(per_cd[name]),
                         "emd": statistics.mean(per_emd[name])}
        print(f"Class: {name} -- Rec CD: {results[name]['cd']}; "
              f"Rec EMD: {results[name]['emd']}")
    return results
