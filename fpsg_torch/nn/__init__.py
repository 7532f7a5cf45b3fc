"""Backbones, the primitive decoder and its fused node-chain layers
(counterpart of ``fpsg_tpu.nn``)."""

from fpsg_torch.nn.decoder import PrimitiveDecoder
from fpsg_torch.nn.normalization import BatchNorm
from fpsg_torch.nn.pointnet import PointNetEncoder, PointNetFeat, STN3d
from fpsg_torch.nn.templates import SphereTemplate, SquareTemplate, get_template
from fpsg_torch.nn.vgg import VGG16BN, ImageEncoder

__all__ = [
    "BatchNorm", "STN3d", "PointNetFeat", "PointNetEncoder", "VGG16BN",
    "ImageEncoder", "PrimitiveDecoder", "SquareTemplate", "SphereTemplate",
    "get_template",
]
