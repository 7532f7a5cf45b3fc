"""Batch normalization with PyTorch semantics
(counterpart of ``fpsg_tpu/nn/normalization.py``).

- ``shift=``: the preceding layer's bias is folded into the BN instead
  of being added to the activation. In training it cancels out of the
  normalization and only offsets the running-mean update; in eval the
  running mean was accumulated with the bias and the input here is
  bias-less, so ``mean = running_mean - shift``
  (``normalization.py:267-273``). The bias therefore gets no gradient
  (``None``), where the JAX package's is exactly 0; Adam leaves it
  unchanged either way.
- stacked ``feature_axes``: ``(-1,)`` for a plain channel BN, ``(1, -1)``
  for the per-cluster deformer BNs, ``(0, 1, -1)`` for the per-(cluster,
  node) BNs on group-major activations; parameters and statistics have
  the shape of those axes.
- ``group_axes``: input axes that get separate batch statistics in
  training while sharing one running estimate, updated as if the groups
  had been processed one after another in index order
  (``normalization.py:337-372``): the deformer BNs, called once per node
  by the reference, use ``group_axes=(2,)``.
- training (``self.training``): batch mean and biased variance over the
  remaining axes, in one of two forms (``two_pass``):
  - ``two_pass=True`` (the ``precise_stats`` form): ``torch.var_mean``,
    no ``E[x^2] - E[x]^2`` cancellation;
  - ``two_pass=False`` (the single-read shifted variance,
    ``normalization.py:299-313``): with the constant
    ``s = stop_grad(running_mean - shift)``,
    ``var = max(E[(x - s)^2] - (E[x] - s)^2, 0)``; ``s`` tracks the batch
    mean, so the subtraction does not cancel, and a kernel can take both
    statistics from one read of ``x``.
  Torch momentum 0.1 and the unbiased (``n / (n - 1)``) variance in the
  running estimate. The gradient is autograd's, through the statistics.
- the collapsed affine ``k = rsqrt(var + eps) * scale``, ``b_eff = bias -
  mean * k`` in f32 (``normalization.py:374-402``), applied in the output
  dtype (bf16 in bf16 mode, else f32), with relu fused when
  ``activation="relu"``. (The JAX module normalizes an f32 BN without relu
  in the uncollapsed form; no such BN is applied to a tensor on the
  ported paths.)
- :meth:`BatchNorm.affine` is the ``return_affine`` mode: it hands
  ``(k, b_eff)`` to a caller that applies them itself (inside a kernel, or
  commuted through a max).
- stats injection (``normalization.py:153-215``), for a kernel that reads
  the big tensor itself: :meth:`BatchNorm.stat_shift` is the
  ``return_shift`` mode (the ``s`` the kernel subtracts before it sums),
  :meth:`BatchNorm.affine_from_stats` the ``stats=(mean, var, n)`` +
  ``return_affine`` mode (the running-estimate update of the tensor path,
  then ``(k, b_eff)`` in f32).

Not ported: ``phase_groups`` (the port has no space-to-depth block 1).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn


MOMENTUM = 0.1      # torch convention: the new batch statistic's weight


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """Statistics in at least f32 (f64 for f64 inputs, as in JAX)."""
    return torch.promote_types(x.dtype, torch.float32)


class BatchNorm(nn.Module):
    """Torch-semantics batch norm over stacked feature axes.

    Args:
      param_shape: shape of scale/bias and the running statistics — the
        sizes of ``feature_axes`` of the input, in axis order.
      feature_axes: input axes that carry ``param_shape``.
      group_axes: input axes with their own batch statistics in training.
      activation: ``"relu"`` fuses relu into the affine, or ``None``.
      dtype: output dtype (``None``: the input's).
      two_pass: the two-pass batch variance; False takes the single-read
        shifted form.
    """

    def __init__(self, param_shape: Sequence[int],
                 feature_axes: Tuple[int, ...] = (-1,),
                 epsilon: float = 1e-5,
                 activation: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None,
                 group_axes: Tuple[int, ...] = (),
                 two_pass: bool = True):
        super().__init__()
        if activation not in (None, "relu"):
            raise NotImplementedError(activation)
        shape = tuple(param_shape)
        self.feature_axes = tuple(feature_axes)
        self.group_axes = tuple(group_axes)
        self.two_pass = two_pass
        self.epsilon = epsilon
        self.activation = activation
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))
        self.register_buffer("running_mean", torch.zeros(shape))
        self.register_buffer("running_var", torch.ones(shape))

    def _expand(self, v: torch.Tensor, ndim: int) -> torch.Tensor:
        axes = sorted(a % ndim for a in self.feature_axes)
        shape = [1] * ndim
        for a, s in zip(axes, v.shape):
            shape[a] = s
        return v.reshape(shape)

    def _batch_stats(self, x: torch.Tensor, shift: Optional[torch.Tensor]):
        """Per-(feature x group) batch mean and biased variance of ``x``
        (f32, or f64 for f64 ``x``), keepdims; updates the running
        estimates."""
        nd = x.dim()
        f_axes = {a % nd for a in self.feature_axes}
        g_axes = sorted(a % nd for a in self.group_axes)
        reduce = [a for a in range(nd) if a not in f_axes and a not in g_axes]
        xf = x.to(_stat_dtype(x))
        if self.two_pass:
            var, mean = torch.var_mean(xf, dim=reduce, correction=0,
                                       keepdim=True)
        else:
            s = self._expand(self.stat_shift(shift).to(xf.dtype), nd)
            mean = torch.mean(xf, dim=reduce, keepdim=True)
            d = xf - s
            delta = mean - s
            var = torch.clamp_min(torch.mean(d * d, dim=reduce, keepdim=True)
                                  - delta * delta, 0.0)
        n = 1
        for a in reduce:
            n *= x.shape[a]
        with torch.no_grad():
            self._update_running(mean.detach(), var.detach(), n, reduce,
                                 g_axes, shift)
        return mean, var

    def _update_running(self, mean, var, n, reduce, g_axes, shift) -> None:
        """``r' = (1-m)^G r + m * sum_g (1-m)^(G-1-g) s_g`` over the G
        groups in index order (G = 1 without group axes)."""
        m = MOMENTUM
        kept = [a for a in range(mean.dim()) if a not in reduce]
        order = [kept.index(a) for a in g_axes] + \
            [i for i, a in enumerate(kept) if a not in g_axes]
        pshape = tuple(self.running_mean.shape)

        def grouped(s):
            return s.squeeze(reduce).permute(order).reshape((-1,) + pshape)

        mean_g, var_g = grouped(mean), grouped(var) * (n / max(n - 1, 1))
        if shift is not None:
            mean_g = mean_g + torch.broadcast_to(shift.detach(), pshape)
        groups = mean_g.shape[0]
        w = m * (1.0 - m) ** torch.arange(groups - 1, -1, -1,
                                           dtype=torch.float32,
                                           device=mean.device)
        decay = (1.0 - m) ** groups
        self.running_mean.copy_(decay * self.running_mean
                                + torch.tensordot(w.to(mean_g), mean_g, 1))
        self.running_var.copy_(decay * self.running_var
                               + torch.tensordot(w.to(var_g), var_g, 1))

    def stat_shift(self, shift: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """The single-read statistics' shift ``s = running_mean - shift``
        in ``param_shape``, f32, without gradient."""
        s = self.running_mean.float()
        if shift is not None:
            s = s - torch.broadcast_to(shift.detach().float(), s.shape)
        return s.detach()

    def affine_from_stats(self, mean: torch.Tensor, var: torch.Tensor,
                          n: int, shift: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stats injection: ``mean``, ``var`` (``param_shape``) are the batch
        statistics of the bias-less input over ``n`` elements, computed by
        the caller (a kernel). Updates the running estimates as the tensor
        path does (momentum, Bessel, shift fold) and returns the collapsed
        affine ``(k, b_eff)`` in f32, differentiable in ``mean``, ``var``
        and the parameters."""
        if self.group_axes:
            raise ValueError("injected statistics have no group axes")
        mean, var = mean.float(), var.float()
        with torch.no_grad():
            m = MOMENTUM
            up = mean if shift is None else \
                mean + torch.broadcast_to(shift.float(), mean.shape)
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * up)
            self.running_var.copy_((1.0 - m) * self.running_var
                                   + m * var * (n / max(n - 1, 1)))
        k = torch.rsqrt(var + self.epsilon) * self.weight.float()
        return k, self.bias.float() - mean * k

    def affine(self, shift: Optional[torch.Tensor] = None,
               x: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The collapsed per-feature affine ``(k, b_eff)`` in
        ``param_shape``, for an input without the folded ``shift``: f32 (the
        statistics' dtype). In training the statistics are ``x``'s batch
        statistics (which updates the running estimates; no group axes);
        in eval the running ones."""
        if self.training:
            if self.group_axes:
                raise ValueError("affine() has one affine per feature; "
                                 "group statistics need forward()")
            mean, var = self._batch_stats(x, shift)
            shape = self.running_mean.shape
            mean, var = mean.reshape(shape), var.reshape(shape)
            k = torch.rsqrt(var + self.epsilon) * self.weight.to(mean)
            return k, self.bias.to(mean) - mean * k
        mean = self.running_mean.float()
        if shift is not None:
            mean = mean - torch.broadcast_to(shift.float(), mean.shape)
        var = self.running_var.float()
        k = torch.rsqrt(var + self.epsilon) * self.weight.float()
        return k, self.bias.float() - mean * k

    def forward(self, x: torch.Tensor,
                shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        nd = x.dim()
        out_dtype = self.dtype or x.dtype
        if self.training:
            mean, var = self._batch_stats(x, shift)
            k = torch.rsqrt(var + self.epsilon) \
                * self._expand(self.weight.to(mean), nd)
            b = self._expand(self.bias.to(mean), nd) - mean * k
        else:
            k, b = self.affine(shift)
            k, b = self._expand(k, nd), self._expand(b, nd)
        cd = out_dtype if out_dtype == torch.bfloat16 else _stat_dtype(x)
        y = x.to(cd) * k.to(cd) + b.to(cd)
        if self.activation == "relu":
            y = torch.relu(y)
        return y.to(out_dtype)
