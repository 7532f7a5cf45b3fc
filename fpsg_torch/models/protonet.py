"""The generator network: image branch + prototype branch + primitive
decoder (counterpart of ``fpsg_tpu/models/protonet.py``).

Training (``model.train()``):

- :meth:`ImgPCProtoNet.loss` (also ``forward``): the episodic objective
  (``protonet.py:254-296``). Images are encoded as one batch [ad ‖
  query], clouds as one batch [support ‖ ad] (``_encode``,
  ``protonet.py:202-228``), so the BatchNorm statistics are the
  reference's; the prototype is the mean of the support features; the
  decoder runs on [img_q ‖ proto] and, with ``intra_support``, on
  [img_ad ‖ pc_ad]; each reconstruction is the Chamfer distance summed
  over its batch (``metric="cd"``), or the Sinkhorn EMD at the training
  loss's settings (``metric="emd"``, ``--pc_dist emd``).
- ``decoder_fused`` (``"auto"``, ``"on"``, ``"off"``) picks the decoder's
  node chain in training (``protonet.py:115``; see
  :class:`~fpsg_torch.nn.decoder.PrimitiveDecoder`): ``"auto"`` fuses it
  on the card with single-read statistics. ``pc_decoder.fused`` holds it.
- The encoders and the decoder compute in the model's dtype (bf16 in bf16
  mode); their outputs, the prototype, the losses and the Chamfer
  distances are f32. BatchNorm statistics are single-read (``node_bn1``
  excepted), or two-pass everywhere with ``precise_stats``
  (``conf.precise_stats``).

Eval (``model.eval()``):

- :meth:`ImgPCProtoNet.encode_prototype`: PointNet over the support clouds,
  then the mean (``protonet.py:316-322``).
- :meth:`ImgPCProtoNet.generate_from_proto` /
  :meth:`ImgPCProtoNet.decode_from_embedding`: VGG16-bn, then the decoder
  on ``[img_z ‖ proto]`` with a shared ``(F,)`` or per-item ``(B, F)``
  prototype (``protonet.py:324-370``).
- :meth:`ImgPCProtoNet.generate`: both, from a sample dict.
- :meth:`ImgPCProtoNet.reconstruct`: the evaluator's CD and EMD of the
  query reconstructions, in eval mode whatever the module's mode, for
  one episode or a batch of episodes.

Only ``aggregate="single"`` is ported (``mask_single`` waits), with the
``vgg_16`` image backbone and the ``pointnet`` cloud backbone.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from fpsg_torch.config import FPSGConfig
from fpsg_torch.nn.decoder import PrimitiveDecoder
from fpsg_torch.nn.pointnet import PointNetEncoder
from fpsg_torch.nn.templates import get_template
from fpsg_torch.nn.vgg import ImageEncoder
from fpsg_torch.ops.chamfer import chamfer_distance
from fpsg_torch.ops.emd import sinkhorn_emd

IMG_FEATURES = 512    # VGG16 embedding width
PC_FEATURES = 1024    # PointNet prototype width


def resolve_device(device) -> torch.device:
    """The requested device; raises if it is CUDA and there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


def compute_dtype(conf: FPSGConfig) -> Optional[torch.dtype]:
    if conf.compute_dtype not in ("f32", "bf16"):
        raise ValueError(f"compute_dtype {conf.compute_dtype!r}")
    return torch.bfloat16 if conf.compute_dtype == "bf16" else None


class ImgPCProtoNet(nn.Module):
    """Few-shot single-image point-cloud generator."""

    def __init__(self, img_backbone: str = "vgg_16",
                 pc_backbone: str = "pointnet", num_clusters: int = 4,
                 num_nodes: int = 4, num_points: int = 2048,
                 bottleneck_size: int = 1536, ori_dim: int = 2,
                 raw_dim: int = 3, template_type: str = "SQUARE",
                 activation: str = "relu", aggregate: str = "single",
                 query_factor: float = 1.0, support_factor: float = 1.0,
                 metric: str = "cd", intra_support: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 precise_stats: bool = False, decoder_fused: str = "auto"):
        super().__init__()
        if aggregate != "single":
            raise NotImplementedError(f"aggregate {aggregate!r} is not ported")
        if pc_backbone != "pointnet":
            raise NotImplementedError(
                f"point-cloud backbone {pc_backbone!r} is not ported")
        if metric not in ("cd", "emd"):
            raise NotImplementedError(f"metric {metric!r} is not ported")
        self.metric = metric
        self.query_factor, self.support_factor = query_factor, support_factor
        self.intra_support = intra_support
        self.dtype = dtype
        self.img_encoder = ImageEncoder(img_backbone, dtype, generator,
                                        precise_stats)
        self.pc_encoder = PointNetEncoder(dtype, generator, precise_stats)
        self.pc_decoder = PrimitiveDecoder(
            num_clusters=num_clusters, num_nodes=num_nodes,
            num_points=num_points, bottleneck_size=bottleneck_size,
            d_cond=IMG_FEATURES + PC_FEATURES, ori_dim=ori_dim,
            raw_dim=raw_dim, template_type=template_type,
            activation=activation, dtype=dtype, generator=generator,
            precise_stats=precise_stats, fused=decoder_fused)

    @classmethod
    def from_config(cls, conf: FPSGConfig, device="cuda") -> "ImgPCProtoNet":
        """Random-init model (torch-default U(+-1/sqrt(fan_in)) weights,
        BN at scale 1, bias 0, running mean 0, var 1) drawn from
        ``conf.seed``, in eval mode on ``device``."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(conf.seed)
        return build_model(conf, gen).to(device).eval()

    # -- training ----------------------------------------------------------

    def _encode(self, sample: Dict[str, torch.Tensor]):
        """``(img_zad, img_zq, pc_z_ad, proto_mat_q)`` of a batch of E
        episodes, each (E, S or Q, F): images as [ad ‖ query] and clouds
        as [support ‖ ad], each episode after the other in one batch."""
        xq, xad = sample["xq"], sample["xad"]
        e, n_support, n_query = xq.shape[0], xad.shape[1], xq.shape[1]
        img_z = self.img_encoder(torch.cat([xad, xq], dim=1).flatten(0, 1))
        img_z = img_z.unflatten(0, (e, n_support + n_query))
        pc_z = self.pc_encoder(torch.cat([sample["pcs"], sample["pcad"]],
                                         dim=1).flatten(0, 1))
        pc_z = pc_z.unflatten(0, (e, 2 * n_support))
        proto = pc_z[:, :n_support].mean(dim=1, keepdim=True)
        return (img_z[:, :n_support], img_z[:, n_support:],
                pc_z[:, n_support:], proto.expand(e, n_query, proto.shape[-1]))

    def _pc_dist(self, syn: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        """The reconstruction metric per cloud (B,). The EMD takes the
        training loss's cheap entropic settings (``protonet.py:242-247``):
        gradients need only the plan's direction; :meth:`reconstruct`
        scores with the accurate defaults."""
        if self.metric == "cd":
            return chamfer_distance(syn, ref)
        return sinkhorn_emd(syn, ref, eps=0.01, n_iters=100)

    def loss(self, sample: Dict[str, torch.Tensor],
             template_points: Optional[Dict[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """The training objective of one episode: ``ttl_loss``,
        ``recon_loss``, ``query_rec_loss``, ``support_rec_loss`` (scalars).

        ``sample``: ``xq`` (Q, H, W, 3) and ``xad`` (S, H, W, 3) images in
        [-1, 1]; ``pcs``, ``pcad`` (S, N, 3) and ``pcq`` (Q, N, 3) clouds.
        Each reconstruction is ``metric`` summed over its clouds.
        ``template_points`` optionally pins the decoder's template draws
        (``"query"`` / ``"support"``: (B, C, Nn, P, ori)); otherwise each
        decoder pass draws from ``generator``.

        In eval mode the fields may carry a leading episode axis E (as
        :func:`~fpsg_torch.data.corpus.sample_episode_batch` gives them):
        the losses are then (E,), and the template points are for the
        E x Q (E x S) clouds, episode-major. Training takes one episode:
        its batch statistics are the episode's own."""
        batched = sample["xq"].dim() == 5
        if batched and self.training:
            raise ValueError("a batch of episodes needs eval mode: training "
                             "statistics are per episode")
        if not batched:
            sample = {k: sample[k][None]
                      for k in ("xq", "xad", "pcs", "pcad", "pcq")}
        tp = template_points or {}
        e = sample["xq"].shape[0]
        img_zad, img_zq, pc_z_ad, proto_mat_q = self._encode(sample)
        syn_q = self.pc_decoder(
            torch.cat([img_zq, proto_mat_q], dim=-1).flatten(0, 1),
            tp.get("query"), generator)
        loss_q = self._pc_dist(syn_q, sample["pcq"].flatten(0, 1)) \
            .reshape(e, -1).sum(dim=1)
        if self.intra_support:
            # conditioned on per-item ad features, not the prototype
            syn_s = self.pc_decoder(
                torch.cat([img_zad, pc_z_ad], dim=-1).flatten(0, 1),
                tp.get("support"), generator)
            loss_s = self._pc_dist(syn_s, sample["pcad"].flatten(0, 1)) \
                .reshape(e, -1).sum(dim=1)
        else:
            loss_s = torch.zeros((e,), device=loss_q.device)
        recon = self.query_factor * loss_q + self.support_factor * loss_s
        out = {"ttl_loss": recon, "recon_loss": recon,
               "query_rec_loss": loss_q, "support_rec_loss": loss_s}
        return out if batched else {k: v[0] for k, v in out.items()}

    def forward(self, sample: Dict[str, torch.Tensor],
                template_points: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        return self.loss(sample, template_points, generator)

    # -- eval --------------------------------------------------------------

    def encode_prototype(self, pcs: torch.Tensor) -> torch.Tensor:
        """Class prototype (F,) from support clouds (S, N, 3)."""
        return torch.mean(self.pc_encoder(pcs), dim=0)

    def generate_from_proto(self, xq: torch.Tensor, proto: torch.Tensor,
                            template_points: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
        """Query clouds (B, num_points, 3) from images (B, H, W, 3) in
        [-1, 1] and a prototype (F,) or (B, F)."""
        return self.decode_from_embedding(self.img_encoder(xq), proto,
                                          template_points, generator)

    def decode_from_embedding(self, img_z: torch.Tensor, proto: torch.Tensor,
                              template_points: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
        n_query = img_z.shape[0]
        if proto.dim() == 1:
            proto_mat = proto[None].expand(n_query, proto.shape[-1])
        else:
            if proto.shape[0] != n_query:
                raise ValueError(f"per-item proto batch {tuple(proto.shape)} "
                                 f"for {n_query} query images")
            proto_mat = proto
        return self.pc_decoder(torch.cat([img_z, proto_mat], dim=1),
                               template_points, generator)

    def generate(self, sample: Dict[str, torch.Tensor],
                 template_points: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Query clouds from ``sample["xq"]`` with the prototype of the
        SUPPORT clouds ``sample["pcs"]``."""
        proto = self.encode_prototype(sample["pcs"])
        return self.generate_from_proto(sample["xq"], proto, template_points,
                                        generator)


    def reconstruct(self, sample: Dict[str, torch.Tensor],
                    template_points: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """The evaluator's scores of the query reconstructions
        (``protonet.py:298-314``; the reference's
        ``_return_reconstruction``): ``cd_loss = query_factor * sum_q
        CD``, ``emd_loss = sum_q EMD`` at the accurate defaults of
        :func:`~fpsg_torch.ops.emd.sinkhorn_emd`, and ``syn_pc`` (Q,
        num_points, 3), from the prototype of the support clouds ``pcs``
        and the query images ``xq``.

        BatchNorm always runs on its running statistics, as JAX's
        ``train=False`` does, whatever mode the module is in (it is
        restored after), and no running statistic moves. Fields may carry
        a leading episode axis E, as in :meth:`loss`: the scores are then
        (E,) and ``syn_pc`` (E, Q, num_points, 3). ``template_points`` (E
        x Q, C, Nn, P, ori) pins the decoder's draws; otherwise they come
        from ``generator``. Only the fields this reads are encoded (JAX
        drops the ad branch as dead code)."""
        batched = sample["xq"].dim() == 5
        xq, pcs, pcq = (sample[k] if batched else sample[k][None]
                        for k in ("xq", "pcs", "pcq"))
        e, n_query, n_support = xq.shape[0], xq.shape[1], pcs.shape[1]
        was_training = self.training
        self.eval()
        try:
            img_zq = self.img_encoder(xq.flatten(0, 1))
            proto = self.pc_encoder(pcs.flatten(0, 1)).unflatten(
                0, (e, n_support)).mean(dim=1)
            proto_q = proto[:, None].expand(e, n_query, proto.shape[-1])
            syn = self.pc_decoder(
                torch.cat([img_zq, proto_q.flatten(0, 1)], dim=1),
                template_points, generator)
        finally:
            self.train(was_training)
        ref = pcq.flatten(0, 1)
        cd = chamfer_distance(syn, ref).reshape(e, n_query).sum(dim=1)
        emd = sinkhorn_emd(syn, ref).reshape(e, n_query).sum(dim=1)
        out = {"cd_loss": self.query_factor * cd, "emd_loss": emd,
               "syn_pc": syn.unflatten(0, (e, n_query))}
        return out if batched else {k: v[0] for k, v in out.items()}


def build_model(conf: FPSGConfig,
                generator: Optional[torch.Generator] = None) -> ImgPCProtoNet:
    """The model for ``conf`` on the CPU, weights drawn from ``generator``
    (counterpart of ``fpsg_tpu/train/loop.py:build_model``)."""
    return ImgPCProtoNet(
        img_backbone=conf.img_encoder, pc_backbone=conf.pc_encoder,
        num_clusters=conf.num_clusters, num_nodes=conf.num_nodes,
        num_points=conf.num_points, bottleneck_size=conf.bottleneck_size,
        ori_dim=conf.ori_dim, raw_dim=conf.raw_dim,
        template_type=conf.template_type, activation=conf.activation,
        aggregate=conf.aggregate, query_factor=conf.query_factor,
        support_factor=conf.support_factor, metric=conf.pc_dist,
        intra_support=conf.intra_recon, dtype=compute_dtype(conf),
        generator=generator, precise_stats=conf.precise_stats)


def per_item_template_points(model: ImgPCProtoNet,
                             seeds: Sequence[int]) -> torch.Tensor:
    """(B, C, Nn, P, ori) template draws, row i from its own generator
    seeded by ``seeds[i]``: a pure function of that seed alone, not of the
    batch size or the other rows (counterpart of
    ``protonet.py:per_item_template_points``)."""
    dec = model.pc_decoder
    template = get_template(dec.template_type)
    shape = (dec.num_clusters, dec.num_nodes, dec.points_per_node,
             dec.ori_dim)
    rows = [template.get_random_points(
        shape, torch.Generator().manual_seed(int(s))) for s in seeds]
    return torch.stack(rows)
