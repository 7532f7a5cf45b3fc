"""Shape-primitive point-cloud decoder, eval mode
(counterpart of ``fpsg_tpu/nn/decoder.py``).

``num_clusters`` clusters, each one shared deformer plus ``num_nodes``
node MLPs, with every cluster and node parameter stacked on leading axes:

- the per-cluster deformer ``ori -> 128 -> 128 -> raw`` with tanh
  (``decoder.py:220-265``), BN over feature axes ``(1, -1)``;
- node layer 1 with the conditioning half of its kernel hoisted out of the
  point dimension (``decoder.py:91-140, 356-366``): ``kh = W1[..., :d_cond,
  :]``, ``kd = W1[..., d_cond:, :]``, ``y_cond = einsum("be,cnef->cnbf")``;
- the node chain ``d_node -> d_node -> d_node//2 -> d_node//4 -> raw``
  through the three fused kernels of ``nn/fused_stack.py``, in group-major
  ``(C, Nn, R = B*P, D)`` layout, each BN as its collapsed eval affine;
- output ordered cluster-major, then node, then point
  (``decoder.py:426-430``).

Stacked weights keep the JAX ``(*groups, d_in, d_out)`` layout: it is the
kernels' layout. Template points are drawn from a ``torch.Generator`` on
the CPU (so a seed gives the same points on every device) unless passed in.
Only ``activation="relu"`` is ported: the kernels fuse relu.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from fpsg_torch.nn._init import uniform_fan_in
from fpsg_torch.nn.fused_stack import (
    fused_l1_layer, fused_mid_layer, fused_out_layer,
)
from fpsg_torch.nn.normalization import BatchNorm
from fpsg_torch.nn.templates import get_template


class StackedDense(nn.Module):
    """Dense layer with parameters stacked over leading group axes:
    ``weight`` (*groups, d_in, d_out), ``bias`` (*groups, d_out)."""

    def __init__(self, groups: Tuple[int, ...], d_in: int, d_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            uniform_fan_in((*groups, d_in, d_out), d_in, generator))
        self.bias = nn.Parameter(
            uniform_fan_in((*groups, d_out), d_in, generator))

    def cluster_matmul(self, x: torch.Tensor, dt: torch.dtype):
        """``x`` (B, C, P, d_in) @ the per-cluster weight -> (B, C, P, d_out)
        in ``dt``."""
        return torch.einsum("bcpd,cde->bcpe", x.to(dt), self.weight.to(dt))


class PrimitiveDecoder(nn.Module):
    """(B, d_cond) conditioning -> (B, num_points, raw_dim) point cloud."""

    def __init__(self, num_clusters: int = 4, num_nodes: int = 4,
                 num_points: int = 2048, bottleneck_size: int = 1536,
                 d_cond: int = 1536, ori_dim: int = 2, raw_dim: int = 3,
                 template_type: str = "SQUARE", activation: str = "relu",
                 deformer_width: int = 128,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation != "relu":
            raise NotImplementedError(
                f"decoder activation {activation!r} is not ported (the "
                "fused node-chain kernels apply relu)")
        if get_template(template_type).dim != ori_dim:
            raise ValueError(f"template {template_type} is not {ori_dim}-d")
        c, n, w = num_clusters, num_nodes, deformer_width
        self.num_clusters, self.num_nodes = c, n
        self.num_points, self.ori_dim, self.raw_dim = num_points, ori_dim, \
            raw_dim
        self.template_type = template_type
        self.d_cond = d_cond
        self.dtype = dtype
        g = generator
        self.deformer_conv1 = StackedDense((c,), ori_dim, w, g)
        self.deformer_conv2 = StackedDense((c,), w, w, g)
        self.deformer_conv3 = StackedDense((c,), w, raw_dim, g)
        self.deformer_bn1 = BatchNorm((c, w), (1, -1), activation="relu",
                                      dtype=dtype)
        self.deformer_bn2 = BatchNorm((c, w), (1, -1), activation="relu",
                                      dtype=dtype)
        d_node = raw_dim + bottleneck_size
        self.dims = [d_node, d_node, d_node // 2, d_node // 4, raw_dim]
        self.node_conv1 = StackedDense((c, n), d_cond + raw_dim,
                                       self.dims[1], g)
        for i in (2, 3, 4):
            self.add_module(f"node_conv{i}", StackedDense(
                (c, n), self.dims[i - 1], self.dims[i], g))
        for i in (1, 2, 3):
            self.add_module(f"node_bn{i}", BatchNorm(
                (c, n, self.dims[i]), (1, 2, -1), dtype=dtype))

    @property
    def points_per_node(self) -> int:
        return self.num_points // self.num_clusters // self.num_nodes

    def template_points(self, batch: int,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """One (B, C, Nn, P, ori) draw on the CPU."""
        return get_template(self.template_type).get_random_points(
            (batch, self.num_clusters, self.num_nodes, self.points_per_node,
             self.ori_dim), generator)

    def forward(self, h: torch.Tensor,
                template_points: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = h.shape[0]
        c, n = self.num_clusters, self.num_nodes
        if template_points is None:
            template_points = self.template_points(b, generator)
        raw = template_points.to(h.device)                 # (B, C, Nn, P, ori)
        p = raw.shape[3]
        dt = self.dtype or torch.float32

        # --- shared per-cluster deformer ---------------------------------
        x = raw.to(dt).reshape(b, c, n * p, self.ori_dim)
        d = self.deformer_conv1.cluster_matmul(x, dt).reshape(b, c, n, p, -1)
        d = self.deformer_bn1(d, shift=self.deformer_conv1.bias)
        d = self.deformer_conv2.cluster_matmul(d.reshape(b, c, n * p, -1), dt)
        d = self.deformer_bn2(d.reshape(b, c, n, p, -1),
                              shift=self.deformer_conv2.bias)
        d = self.deformer_conv3.cluster_matmul(d.reshape(b, c, n * p, -1), dt)
        d = torch.tanh(d + self.deformer_conv3.bias[None, :, None, :].to(dt))
        d = d.reshape(b, c, n, p, self.raw_dim)

        # --- node chain, group-major (C, Nn, R = B*P, D) ------------------
        r = b * p
        dg = d.permute(1, 2, 0, 3, 4).reshape(c, n, r, self.raw_dim)
        w1 = self.node_conv1.weight
        kh = w1[..., :self.d_cond, :].to(dt)
        kd = w1[..., self.d_cond:, :].to(dt)
        # einsum("be,cnef->cnbf"); a broadcast batched matmul reads kh in
        # place, where einsum would first copy it to (e, c*n*f) layout
        y_cond = torch.matmul(h.to(dt), kh)                    # (C,Nn,B,F)
        y = fused_l1_layer(dg.contiguous(), kd.contiguous(),
                           y_cond.float().contiguous(), p)
        k, bb = self.node_bn1.affine(shift=self.node_conv1.bias)
        for i in (2, 3):
            conv = getattr(self, f"node_conv{i}")
            y = fused_mid_layer(y, k, bb, conv.weight.to(dt))
            k, bb = getattr(self, f"node_bn{i}").affine(shift=conv.bias)
        out = fused_out_layer(y, k, bb, self.node_conv4.weight.to(dt),
                              self.node_conv4.bias.float())  # (C,Nn,R,raw) f32
        out = out.reshape(c, n, b, p, self.raw_dim)
        return out.permute(2, 0, 1, 3, 4).reshape(b, c * n * p, self.raw_dim)
