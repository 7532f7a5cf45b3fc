"""The generator model of the port (counterpart of ``fpsg_tpu.models``)."""

from fpsg_torch.models.protonet import (
    ImgPCProtoNet, build_model, per_item_template_points,
)

__all__ = ["ImgPCProtoNet", "build_model", "per_item_template_points"]
