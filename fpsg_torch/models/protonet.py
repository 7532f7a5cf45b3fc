"""The generator network: image branch + prototype branch + primitive
decoder, eval-mode entry points (counterpart of
``fpsg_tpu/models/protonet.py``).

- :meth:`ImgPCProtoNet.encode_prototype`: PointNet over the support clouds,
  then the mean (``protonet.py:316-322``).
- :meth:`ImgPCProtoNet.generate_from_proto` /
  :meth:`ImgPCProtoNet.decode_from_embedding`: VGG16-bn, then the decoder
  on ``[img_z ‖ proto]`` with a shared ``(F,)`` or per-item ``(B, F)``
  prototype (``protonet.py:324-370``).
- :meth:`ImgPCProtoNet.generate`: both, from a sample dict.

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
    """Few-shot single-image point-cloud generator (eval mode)."""

    def __init__(self, img_backbone: str = "vgg_16",
                 pc_backbone: str = "pointnet", num_clusters: int = 4,
                 num_nodes: int = 4, num_points: int = 2048,
                 bottleneck_size: int = 1536, ori_dim: int = 2,
                 raw_dim: int = 3, template_type: str = "SQUARE",
                 activation: str = "relu", aggregate: str = "single",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggregate != "single":
            raise NotImplementedError(f"aggregate {aggregate!r} is not ported")
        if pc_backbone != "pointnet":
            raise NotImplementedError(
                f"point-cloud backbone {pc_backbone!r} is not ported")
        self.dtype = dtype
        self.img_encoder = ImageEncoder(img_backbone, dtype, generator)
        self.pc_encoder = PointNetEncoder(dtype, generator)
        self.pc_decoder = PrimitiveDecoder(
            num_clusters=num_clusters, num_nodes=num_nodes,
            num_points=num_points, bottleneck_size=bottleneck_size,
            d_cond=IMG_FEATURES + PC_FEATURES, ori_dim=ori_dim,
            raw_dim=raw_dim, template_type=template_type,
            activation=activation, dtype=dtype, generator=generator)

    @classmethod
    def from_config(cls, conf: FPSGConfig, device="cuda") -> "ImgPCProtoNet":
        """Random-init model (torch-default U(+-1/sqrt(fan_in)) weights,
        BN at scale 1, bias 0, running mean 0, var 1) drawn from
        ``conf.seed``, in eval mode on ``device``."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(conf.seed)
        return build_model(conf, gen).to(device).eval()

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
        aggregate=conf.aggregate, dtype=compute_dtype(conf),
        generator=generator)


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
