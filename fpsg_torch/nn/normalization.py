"""Batch normalization with PyTorch semantics, eval mode
(counterpart of ``fpsg_tpu/nn/normalization.py``).

This slice serves, so only the running-statistics path is ported:

- ``shift=``: the preceding layer's bias is folded into the BN instead
  of being added to the activation. The running mean was accumulated
  with the bias, the input here is bias-less, so ``mean = running_mean -
  shift`` (``normalization.py:267-273``).
- stacked ``feature_axes``: ``(-1,)`` for a plain channel BN, ``(1, -1)``
  for the per-cluster deformer BNs, ``(1, 2, -1)`` for the per-(cluster,
  node) BNs; parameters and statistics have the shape of those axes.
- the collapsed affine ``k = rsqrt(var + eps) * scale``, ``b_eff = bias -
  mean * k`` in f32 (``normalization.py:374-402``), applied in the output
  dtype (bf16 in bf16 mode, else f32), with relu fused when
  ``activation="relu"``. (The JAX module normalizes an f32 BN without relu
  in the uncollapsed form; no such BN is applied to a tensor on the
  serving path.)
- :meth:`BatchNorm.affine` is the ``return_affine`` mode: it hands
  ``(k, b_eff)`` to a caller that applies them itself (inside a kernel, or
  commuted through a max).

Train-mode statistics, the single-read shifted variance, ``phase_groups``
and stats injection come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Eval-mode torch-semantics batch norm over stacked feature axes.

    Args:
      param_shape: shape of scale/bias and the running statistics — the
        sizes of ``feature_axes`` of the input, in axis order.
      feature_axes: input axes that carry ``param_shape``.
      activation: ``"relu"`` fuses relu into the affine, or ``None``.
      dtype: output dtype (``None``: the input's).
    """

    def __init__(self, param_shape: Sequence[int],
                 feature_axes: Tuple[int, ...] = (-1,),
                 epsilon: float = 1e-5,
                 activation: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if activation not in (None, "relu"):
            raise NotImplementedError(activation)
        shape = tuple(param_shape)
        self.feature_axes = tuple(feature_axes)
        self.epsilon = epsilon
        self.activation = activation
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))
        self.register_buffer("running_mean", torch.zeros(shape))
        self.register_buffer("running_var", torch.ones(shape))

    def affine(self, shift: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The collapsed per-feature affine ``(k, b_eff)``, f32, in
        ``param_shape``, for an input without the folded ``shift``."""
        mean = self.running_mean.float()
        if shift is not None:
            mean = mean - torch.broadcast_to(shift.float(), mean.shape)
        k = torch.rsqrt(self.running_var.float() + self.epsilon) \
            * self.weight.float()
        return k, self.bias.float() - mean * k

    def _expand(self, v: torch.Tensor, ndim: int) -> torch.Tensor:
        axes = sorted(a % ndim for a in self.feature_axes)
        shape = [1] * ndim
        for a, s in zip(axes, v.shape):
            shape[a] = s
        return v.reshape(shape)

    def forward(self, x: torch.Tensor,
                shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        nd = x.dim()
        out_dtype = self.dtype or x.dtype
        k, b = self.affine(shift)
        cd = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
        y = x.to(cd) * self._expand(k, nd).to(cd) + self._expand(b, nd).to(cd)
        if self.activation == "relu":
            y = torch.relu(y)
        return y.to(out_dtype)
