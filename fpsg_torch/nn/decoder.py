"""Shape-primitive point-cloud decoder
(counterpart of ``fpsg_tpu/nn/decoder.py``).

``num_clusters`` clusters, each one shared deformer plus ``num_nodes``
node MLPs, with every cluster and node parameter stacked on leading axes:

- the per-cluster deformer ``ori -> 128 -> 128 -> raw`` with tanh
  (``decoder.py:220-265``), BN over feature axes ``(1, -1)`` with one set
  of training statistics per node (``group_axes=(2,)``: the reference
  calls the shared deformer once per node);
- node layer 1 with the conditioning half of its kernel hoisted out of the
  point dimension (``decoder.py:91-140, 356-366``): ``kh = W1[..., :d_cond,
  :]``, ``kd = W1[..., d_cond:, :]``, ``y_cond = einsum("be,cnef->cnbf")``;
- the node chain ``d_node -> d_node -> d_node//2 -> d_node//4 -> raw`` in
  group-major ``(C, Nn, R = B*P, D)`` layout. In eval it runs the three
  fused layers of ``nn/fused_stack.py``, each BN as its collapsed eval
  affine. In training, ``fused`` picks the chain (``decoder.py:291-299``):
  - the fused chain (``decoder.py:321-430``): the same three layers with
    their output statistics (``with_stats``) and their backward kernels,
    each BN in stats injection (``BatchNorm.affine_from_stats``): node_bn1
    from ``zsum``, ``zsq``, ``zcov`` and the two-pass moments of the small
    ``y_cond`` (the exact two-pass variance), node_bn2/3 from the
    single-read shifted sums;
  - the unfused chain (``decoder.py:300-319``): batched matmuls, each BN
    with its batch statistics over R, relu, and a tanh output; autograd
    gives the backward.
  ``"auto"`` takes the fused chain for tensors on the card with
  single-read statistics (the card's counterpart of the JAX package's "on
  the TPU"), the unfused one on the CPU and under ``precise_stats``;
  ``"on"`` and ``"off"`` force one;
- BatchNorm statistics (``decoder.py:235-243, 280-319``; PARITY.md:124):
  ``node_bn1`` is always two-pass (at B = 1 its channels are nearly
  constant at a large offset, where the single-read form cancels); the
  deformer BNs and ``node_bn2/3`` are two-pass only under
  ``precise_stats``, single-read otherwise;
- compute in the model's dtype (bf16 in bf16 mode: the deformer, ``h``,
  ``d`` and the node chain), the output f32 after the tanh
  (``decoder.py:270-272, 312-315``);
- output ordered cluster-major, then node, then point
  (``decoder.py:426-430``).

Stacked weights keep the JAX ``(*groups, d_in, d_out)`` layout: it is the
kernels' layout. Template points are drawn from a ``torch.Generator`` on
its device (serving draws on the CPU, so a seed gives the same points on
every device; training draws on the card) unless passed in.
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
                 generator: Optional[torch.Generator] = None,
                 precise_stats: bool = False, fused: str = "auto"):
        super().__init__()
        if fused not in ("auto", "on", "off"):
            raise ValueError(f"fused {fused!r}: 'auto', 'on' or 'off'")
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
        self.precise_stats, self.fused = precise_stats, fused
        g = generator
        self.deformer_conv1 = StackedDense((c,), ori_dim, w, g)
        self.deformer_conv2 = StackedDense((c,), w, w, g)
        self.deformer_conv3 = StackedDense((c,), w, raw_dim, g)
        self.deformer_bn1 = BatchNorm((c, w), (1, -1), activation="relu",
                                      dtype=dtype, group_axes=(2,),
                                      two_pass=precise_stats)
        self.deformer_bn2 = BatchNorm((c, w), (1, -1), activation="relu",
                                      dtype=dtype, group_axes=(2,),
                                      two_pass=precise_stats)
        d_node = raw_dim + bottleneck_size
        self.dims = [d_node, d_node, d_node // 2, d_node // 4, raw_dim]
        self.node_conv1 = StackedDense((c, n), d_cond + raw_dim,
                                       self.dims[1], g)
        for i in (2, 3, 4):
            self.add_module(f"node_conv{i}", StackedDense(
                (c, n), self.dims[i - 1], self.dims[i], g))
        for i in (1, 2, 3):
            self.add_module(f"node_bn{i}", BatchNorm(
                (c, n, self.dims[i]), (0, 1, -1), activation="relu",
                dtype=dtype, two_pass=i == 1 or precise_stats))

    @property
    def points_per_node(self) -> int:
        return self.num_points // self.num_clusters // self.num_nodes

    def template_points(self, batch: int,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """One (B, C, Nn, P, ori) draw on the generator's device (the CPU
        without one)."""
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
        if self.training and self.fused_chain(h):
            out = self._fused_train_chain(dg, kd, y_cond, p, dt)
        elif self.training:
            out = self._train_chain(dg, kd, y_cond, b, p, dt)
        else:
            out = self._eval_chain(dg, kd, y_cond, p, dt)  # (C,Nn,R,raw)
        out = out.reshape(c, n, b, p, self.raw_dim)
        return out.permute(2, 0, 1, 3, 4).reshape(b, c * n * p, self.raw_dim)

    def fused_chain(self, h: torch.Tensor) -> bool:
        """Whether training takes the fused node chain for input ``h``."""
        return self.fused == "on" or (self.fused == "auto" and h.is_cuda
                                      and not self.precise_stats)

    def _train_chain(self, dg, kd, y_cond, b, p, dt):
        """The unfused node chain with batch statistics: ``[y_cond | d] @
        W1`` as the hoisted conditioning term plus the point term, then
        matmul -> BN -> relu twice, then matmul + bias -> tanh, f32 out."""
        c, n = self.num_clusters, self.num_nodes
        y = torch.matmul(dg, kd)                              # (C,Nn,R,F)
        y = (y.reshape(c, n, b, p, -1) + y_cond[:, :, :, None, :]).reshape(
            c, n, b * p, -1)
        x = self.node_bn1(y, shift=self.node_conv1.bias)
        for i in (2, 3):
            conv = getattr(self, f"node_conv{i}")
            x = getattr(self, f"node_bn{i}")(
                torch.matmul(x, conv.weight.to(dt)), shift=conv.bias)
        w4, bias4 = self.node_conv4.weight, self.node_conv4.bias
        return torch.tanh(torch.matmul(x, w4.to(dt))
                          + bias4[:, :, None, :].to(dt)).float()

    def _eval_chain(self, dg, kd, y_cond, p, dt):
        """The node chain through the fused kernels, eval affines."""
        y = fused_l1_layer(dg.contiguous(), kd.contiguous(),
                           y_cond.float().contiguous(), p)
        k, bb = self.node_bn1.affine(shift=self.node_conv1.bias)
        for i in (2, 3):
            conv = getattr(self, f"node_conv{i}")
            y = fused_mid_layer(y, k, bb, conv.weight.to(dt))
            k, bb = getattr(self, f"node_bn{i}").affine(shift=conv.bias)
        return fused_out_layer(y, k, bb, self.node_conv4.weight.to(dt),
                               self.node_conv4.bias.float())

    def _fused_train_chain(self, dg, kd, y_cond, p, dt):
        """The node chain through the fused layers with their output
        statistics, each BN fed the statistics by injection."""
        r = dg.shape[2]
        ycf = y_cond.float()
        mean_s = ycf.mean(dim=2)                              # (C,Nn,F)
        sc = ycf - mean_s[:, :, None, :]
        var_s = (sc * sc).mean(dim=2)
        y, zs, zq, zc = fused_l1_layer(dg, kd, y_cond, p, sc=sc,
                                       with_stats=True)
        mz = zs / r
        # the exact two-pass variance: within (z), covariance and between
        # (y_cond) parts (fpsg_tpu/nn/fused_stack.py:36-55)
        var1 = (zq / r - mz * mz) + 2.0 * zc / r + var_s
        k, bb = self.node_bn1.affine_from_stats(
            mz + mean_s, var1, r, shift=self.node_conv1.bias)
        for i in (2, 3):
            conv = getattr(self, f"node_conv{i}")
            bn = getattr(self, f"node_bn{i}")
            s = bn.stat_shift(conv.bias)
            y, zs, zq = fused_mid_layer(y, k, bb, conv.weight.to(dt), s=s,
                                        with_stats=True)
            mz = zs / r
            var = torch.clamp_min(zq / r - mz * mz, 0.0)
            k, bb = bn.affine_from_stats(mz + s, var, r, shift=conv.bias)
        return fused_out_layer(y, k, bb, self.node_conv4.weight.to(dt),
                               self.node_conv4.bias.float())
