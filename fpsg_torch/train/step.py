"""The episodic train step (counterpart of ``fpsg_tpu/train/step.py``).

    state = init_state(conf)                  # random init from conf.seed
    step = make_train_step(conf)
    gen = torch.Generator(device="cuda").manual_seed(1)
    state, metrics = step(state, corpus, gen)

One optimizer step at one episode per step (E = 1): sample the episode on
the corpus's device, run the model's loss in training mode (each decoder
pass draws its template points from the same generator), backpropagate,
and take one Adam step at the scheduled rate. ``steps_per_call = K > 1``
runs K such steps in one call, one after another on the same generator
(``lax.scan``'s semantics in the JAX package, ``step.py:142-148``), and
stacks the metrics on a leading K axis; 0 (auto) and 1 run one step and
return scalars. Nothing in it waits for the device: the metrics come back
as device tensors.

Supported configuration: one episode per step, the Chamfer metric or
the Sinkhorn EMD (``conf.pc_dist="emd"``, through ``build_model``),
BatchNorm statistics single-read (the default; kernels K3 and K4 at the
PointNet and VGG pool sites) or two-pass (``precise_stats=True``), compute
in ``compute_dtype`` "f32" or "bf16" (parameters, BatchNorm statistics,
losses and the Chamfer distances stay f32), Adam moments in f32 or
``bf16_moments``. The model's ``decoder_fused`` picks the decoder's node
chain in training: on the card with single-read statistics the fused
kernels (K5), else the unfused chain. ``bench.py``'s configuration is
``FPSGConfig(n_shot=32, n_query=1, intra_recon=True, precise_stats=False,
compute_dtype="bf16", bf16_moments=True, steps_per_call=8)``. E > 1
(per-episode statistics, averaged running estimates) and a device mesh
(``dp``, ``mp``) wait for the multi-device slice. The TPU layout pins and
relayout barrier are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from fpsg_torch.config import FPSGConfig
from fpsg_torch.data.corpus import DeviceCorpus, sample_episode
from fpsg_torch.models.protonet import (
    ImgPCProtoNet, build_model, compute_dtype, resolve_device,
)
from fpsg_torch.train.optim import make_lr_schedule, make_optimizer
from fpsg_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


def _check_supported(conf: FPSGConfig) -> None:
    nxt = "comes with the multi-device slice (slice 9)"
    if conf.episodes_per_step != 1:
        raise NotImplementedError(
            f"episodes_per_step={conf.episodes_per_step}: E > 1 episodes "
            f"with per-episode BatchNorm statistics {nxt}")
    if conf.dp != 1 or conf.mp != 1:
        raise NotImplementedError(
            f"dp={conf.dp}, mp={conf.mp}: a device mesh {nxt}")
    compute_dtype(conf)                        # 'f32' or 'bf16'


def init_model(conf: FPSGConfig, device="cuda") -> ImgPCProtoNet:
    """Random-init model from ``conf.seed`` (torch-default weights, BN at
    scale 1, bias 0, running mean 0, var 1) on ``device``, in training
    mode. Raises for CUDA without a card."""
    device = resolve_device(device)
    return build_model(conf, torch.Generator().manual_seed(conf.seed)).to(
        device).train()


def init_state(conf: FPSGConfig, device="cuda") -> TrainState:
    """The model of :func:`init_model` and a fresh Adam. On a card, TF32
    is turned off for cuDNN and cuBLAS (process-wide): the f32 parts of a
    step, bf16 mode's Chamfer distances included, stay full f32."""
    _check_supported(conf)
    model = init_model(conf, device)
    if next(model.parameters()).device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(), conf.lr,
                                               conf.bf16_moments))


def make_train_step(conf: FPSGConfig) -> Callable[
        [TrainState, DeviceCorpus, torch.Generator],
        Tuple[TrainState, Metrics]]:
    """``step(state, corpus, generator) -> (state, metrics)``: K =
    ``conf.steps_per_call`` optimizer updates (1 for 0 or 1), each on one
    episode of ``conf.n_shot`` support and ``conf.effective_n_query`` query
    items. ``metrics``: ``query_rec_loss``, ``support_rec_loss`` and the
    episode's class ``cls``, scalars for K = 1 and stacked ``(K,)``
    otherwise."""
    _check_supported(conf)
    n_support, n_query = conf.n_shot, conf.effective_n_query
    k_steps = max(conf.steps_per_call, 1)
    schedule = make_lr_schedule(conf.lr, conf.lr_decay,
                                conf.n_episode // conf.episodes_per_step)

    def one_step(state: TrainState, corpus: DeviceCorpus,
                 generator: torch.Generator) -> Metrics:
        model = state.model.train()
        batch = sample_episode(corpus, n_support, n_query, generator)
        out = model.loss(batch, generator=generator)
        state.optimizer.zero_grad(set_to_none=True)
        out["ttl_loss"].backward()
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.step()
        state.step += 1
        return {"query_rec_loss": out["query_rec_loss"].detach(),
                "support_rec_loss": out["support_rec_loss"].detach(),
                "cls": batch["cls"]}

    def train_step(state: TrainState, corpus: DeviceCorpus,
                   generator: torch.Generator):
        if k_steps == 1:
            return state, one_step(state, corpus, generator)
        runs = [one_step(state, corpus, generator) for _ in range(k_steps)]
        return state, {k: torch.stack([m[k] for m in runs])
                       for k in runs[0]}

    return train_step
