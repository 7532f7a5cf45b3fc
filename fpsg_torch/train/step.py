"""The episodic train step (counterpart of ``fpsg_tpu/train/step.py``).

    state = init_state(conf)                  # random init from conf.seed
    step = make_train_step(conf)
    gen = torch.Generator(device="cuda").manual_seed(1)
    state, metrics = step(state, corpus, gen)

One step at one episode per step (E = 1): sample the episode on the
corpus's device, run the model's loss in training mode (each decoder pass
draws its template points from the same generator), backpropagate, and
take one Adam step at the scheduled rate. Nothing in it waits for the
device: the metrics come back as device tensors.

Supported configuration: one episode per step, f32 Adam moments, the
Chamfer metric, BatchNorm statistics single-read (the default; kernels K3
and K4 at the PointNet and VGG pool sites) or two-pass
(``precise_stats=True``), compute in ``compute_dtype`` "f32" or "bf16"
(parameters, BatchNorm statistics, losses and the Chamfer distances stay
f32). The decoder runs its unfused node chain in training, as the JAX
package does with ``decoder_fused="off"``. E > 1 (per-episode statistics,
averaged running estimates), ``steps_per_call`` > 1 and ``bf16_moments``
wait for the next training slice, a device mesh (``dp``, ``mp``) for the
multi-device one; ``steps_per_call=0`` (auto) runs one step per call, as
the fused steps' updates are the same. The TPU layout pins and relayout
barrier are not ported.
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
    nxt = "comes with the next training slice (the K5 training kernels)"
    if conf.episodes_per_step != 1:
        raise NotImplementedError(
            f"episodes_per_step={conf.episodes_per_step}: E > 1 {nxt}")
    if conf.steps_per_call > 1:
        raise NotImplementedError(
            f"steps_per_call={conf.steps_per_call}: fused steps {nxt}")
    if conf.bf16_moments:
        raise NotImplementedError(f"bf16_moments: bf16 Adam moments {nxt}")
    if conf.dp != 1 or conf.mp != 1:
        raise NotImplementedError(
            f"dp={conf.dp}, mp={conf.mp}: a device mesh comes with the "
            "multi-device slice")
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
                      optimizer=make_optimizer(model.parameters(), conf.lr))


def make_train_step(conf: FPSGConfig) -> Callable[
        [TrainState, DeviceCorpus, torch.Generator],
        Tuple[TrainState, Metrics]]:
    """``step(state, corpus, generator) -> (state, metrics)``: one episode
    of ``conf.n_shot`` support and ``conf.effective_n_query`` query items,
    one optimizer update. ``metrics``: ``query_rec_loss``,
    ``support_rec_loss`` (scalars) and the episode's class ``cls``."""
    _check_supported(conf)
    n_support, n_query = conf.n_shot, conf.effective_n_query
    schedule = make_lr_schedule(conf.lr, conf.lr_decay,
                                conf.n_episode // conf.episodes_per_step)

    def train_step(state: TrainState, corpus: DeviceCorpus,
                   generator: torch.Generator):
        model = state.model.train()
        batch = sample_episode(corpus, n_support, n_query, generator)
        out = model.loss(batch, generator=generator)
        state.optimizer.zero_grad(set_to_none=True)
        out["ttl_loss"].backward()
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.step()
        state.step += 1
        return state, {"query_rec_loss": out["query_rec_loss"].detach(),
                       "support_rec_loss": out["support_rec_loss"].detach(),
                       "cls": batch["cls"]}

    return train_step
