"""Earth Mover's Distance by entropic (Sinkhorn) optimal transport
(counterpart of ``fpsg_tpu/ops/emd.py``).

For clouds ``x (B, N, D)`` and ``y (B, M, D)`` with uniform marginals
``1/N`` and ``1/M`` and the ground cost ``C_ij = |x_i - y_j|^2``
(:func:`fpsg_torch.ops.pairwise.pairwise_sqdist`), :func:`sinkhorn_emd`
returns the transport cost ``<P, C>`` (no entropy term) of the log-domain
Sinkhorn fixed point, per batch element or reduced.

- The potentials ``f (B, N)``, ``g (B, M)``: :func:`sinkhorn_potentials`.
  A CUDA tensor launches ``csrc/sinkhorn.cu`` (K6, replacing
  ``_sinkhorn_potentials_pallas``, ``emd.py:216-265``; with a warm start
  ``g0``, K11, replacing ``_sinkhorn_potentials_pallas_warm``,
  ``emd.py:273-335``); a CPU tensor runs the plain version
  (:func:`sinkhorn_potentials_plain`): the same iteration on a
  materialized cost matrix.
- The final contraction (``emd.py:535-548``) is plain PyTorch in both
  cases, as JAX computes it outside Pallas: ``P = exp((f + g - C) / eps +
  log_mu + log_nu)`` with the final ``eps``, detached, and ``sum(P * C)``
  with ``C`` differentiable. The gradient reaches ``x`` and ``y`` only
  through ``C`` (the envelope theorem), so no backward kernel exists.
- ``cost="euclidean"`` runs JAX's materialized ``oracle`` loop
  (``emd.py:500-533``) in plain PyTorch on every device: JAX has no kernel
  there either.
- ``coarse > 0`` with ``N, M >= 4 * coarse``: the multiscale warm start
  (``emd.py:461-494``): K6 on a strided subsample at ``eps_mid``, the
  c-transform onto the full cloud in torch ops, then K11.

The iteration (``_sinkhorn_kernel_factory``, ``emd.py:92-206``), pinned
here and in the kernel:

- inputs are cast to f32 first (bf16 decoder outputs in bf16 training);
  ``log_mu = -log(N)``, ``log_nu = -log(M)`` in f32;
- ``eps`` anneals geometrically from ``eps0`` over the first
  ``t_anneal = max(int(n_iters * anneal_frac), 1)`` iterations
  (:func:`_eps_at`, in f32); one table of the ``n_iters`` values is made
  on the tensors' device and read by both versions;
- ``f_i = -e LSE_j[(g_j - C_ij)/e + log_nu]`` reads the previous ``g``;
  ``g_j = -e LSE_i[(f_i - C_ij)/e + log_mu]`` reads the ``f`` just
  relaxed; each stores ``old + w (new - old)`` with ``w = omega`` only
  when ``it > t_anneal``, else 1;
- ``delta = max_i |f_new - f_old|`` of the UNRELAXED step; with ``tol >
  0`` a cloud runs while ``it < n_iters`` and (``it <= t_anneal + 1`` or
  ``delta > tol``); ``tol = 0`` runs all ``n_iters``;
- the exit is PER CLOUD, as in the Pallas kernel (one ``while_loop`` per
  grid program, ``emd.py:189-200``), not batch-wide as in JAX's oracle
  (``emd.py:512``): a cloud's result never depends on the other clouds of
  its batch. The plain version masks finished clouds;
- the g-update's running max starts at ``-1e30`` (``emd.py:179``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fpsg_torch.ops import count_launch, on_card, register_kernel
from fpsg_torch.ops.pairwise import pairwise_sqdist

# Early-exit threshold on the f-step sup-norm, and the post-anneal
# over-relaxation factor: the JAX package's defaults (emd.py:58, 67).
DEFAULT_TOL = 1e-6
DEFAULT_OMEGA = 1.6

KERNEL = "sinkhorn"             # K6: cold start
KERNEL_WARM = "sinkhorn_warm"   # K11: g seeded from a coarse solve
register_kernel(KERNEL)
register_kernel(KERNEL_WARM)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"fpsg_sinkhorn": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                                 _F, _F, _P, _P, _P, _P, _P]}

Potentials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _t_anneal(n_iters: int, anneal_frac: float) -> int:
    return max(int(n_iters * anneal_frac), 1)


def _eps_at(i: torch.Tensor, eps: float, n_iters: int, anneal_frac: float,
            eps0: float) -> torch.Tensor:
    """The annealed epsilon at iterations ``i``, in f32 (``emd.py:82-89``):
    ``eps * exp(log(eps0 / eps) * max(0, 1 - i / t_anneal))``."""
    t_anneal = _t_anneal(n_iters, anneal_frac)
    frac = torch.clamp_min(1.0 - i.float() / t_anneal, 0.0)
    log_ratio = float(torch.log(torch.tensor(eps0 / eps,
                                             dtype=torch.float32)))
    return eps * torch.exp(log_ratio * frac)


def _schedule(eps: float, n_iters: int, anneal_frac: float, eps0: float,
              device: torch.device) -> torch.Tensor:
    """The ``(n_iters,)`` f32 table of :func:`_eps_at`, made on ``device``
    (no host-to-device copy: that would synchronize)."""
    return _eps_at(torch.arange(n_iters, device=device), eps, n_iters,
                   anneal_frac, eps0)


def _log_weight(n: int) -> float:
    """``-log(n)`` computed in f32, as a Python float (exact in f32).
    Scalars stay on the host: a host-to-device copy would synchronize."""
    return -float(torch.log(torch.tensor(float(n), dtype=torch.float32)))


def _check(x: torch.Tensor, y: torch.Tensor,
           g0: Optional[torch.Tensor]) -> None:
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] \
            or x.shape[2] != y.shape[2]:
        raise ValueError(f"expected x (B, N, D), y (B, M, D); got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    if g0 is not None and tuple(g0.shape) != (y.shape[0], y.shape[1]):
        raise ValueError(f"g0 {tuple(g0.shape)} for y {tuple(y.shape)}")


def _lse(v: torch.Tensor, floor: Optional[float] = None) -> torch.Tensor:
    """``max + log(sum(exp(v - max)))`` over the last axis, the max
    clamped below at ``floor`` when given."""
    vm = v.amax(dim=-1, keepdim=True)
    if floor is not None:
        vm = torch.clamp_min(vm, floor)
    return vm.squeeze(-1) + torch.log(torch.exp(v - vm).sum(dim=-1))


def _iterate(c: torch.Tensor, g0: Optional[torch.Tensor], sched, t_anneal,
             omega: float, tol: float, per_cloud: bool) -> Potentials:
    """Sinkhorn iterations on a materialized cost ``c (B, N, M)``.

    ``per_cloud``: each cloud exits on its own ``delta`` (the Pallas
    kernel's rule; finished clouds are masked); else one exit for the
    batch on the batch's largest ``delta`` (JAX's oracle loop). Both
    LSEs reduce over a contiguous last axis (the g-update on ``c``
    transposed), so a cloud's arithmetic is the same in any batch."""
    b, n, m = c.shape
    n_iters = sched.numel()
    log_mu, log_nu = _log_weight(n), _log_weight(m)
    ct = c.transpose(1, 2).contiguous()
    f = torch.zeros((b, n), dtype=torch.float32, device=c.device)
    g = torch.zeros((b, m), dtype=torch.float32, device=c.device) \
        if g0 is None else g0.float().clone()
    iters = torch.zeros((b,), dtype=torch.int32, device=c.device)
    delta = torch.full((b,), 1e30, device=c.device)
    active = torch.ones((b,), dtype=torch.bool, device=c.device)
    for it in range(n_iters):
        if tol > 0.0 and it > t_anneal + 1:
            active = active & (delta > tol)
            if not bool(active.any()):
                break
        e = sched[it]
        w = omega if it > t_anneal else 1.0
        f_new = -e * _lse((g[:, None, :] - c) / e + log_nu)
        step = (f_new - f).abs().amax(dim=-1)
        f_rel = f + w * (f_new - f)
        g_new = -e * _lse((f_rel[:, None, :] - ct) / e + log_mu, -1e30)
        g_rel = g + w * (g_new - g)
        if not per_cloud:
            step = step.amax().expand(b)
        f = torch.where(active[:, None], f_rel, f)
        g = torch.where(active[:, None], g_rel, g)
        delta = torch.where(active, step, delta)
        iters += active.int()
    return f, g, iters


def sinkhorn_potentials_plain(x: torch.Tensor, y: torch.Tensor, *,
                              eps: float, n_iters: int,
                              anneal_frac: float = 0.5, eps0: float = 1.0,
                              tol: float = 0.0, omega: float = 1.0,
                              g0: Optional[torch.Tensor] = None
                              ) -> Potentials:
    """Plain PyTorch version of K6 (``g0=None``) and K11: ``(f (B, N),
    g (B, M), iterations (B,) int32)``, f32, on the inputs' device."""
    _check(x, y, g0)
    sched = _schedule(eps, n_iters, anneal_frac, eps0, x.device)
    return _iterate(pairwise_sqdist(x.float(), y.float()), g0, sched,
                    _t_anneal(n_iters, anneal_frac), float(omega),
                    float(tol), per_cloud=True)


def sinkhorn_potentials_kernel(x: torch.Tensor, y: torch.Tensor, *,
                               eps: float, n_iters: int,
                               anneal_frac: float = 0.5, eps0: float = 1.0,
                               tol: float = 0.0, omega: float = 1.0,
                               g0: Optional[torch.Tensor] = None
                               ) -> Potentials:
    """Launch the CUDA solve (K6, or K11 with ``g0``) on CUDA tensors with
    D = 3: one C call runs the whole iteration loop on the current
    stream, with no host sync. Counts one launch per solve."""
    from fpsg_torch.ops import _build

    _check(x, y, g0)
    if x.shape[2] != 3:
        raise ValueError("sinkhorn kernel takes points with D = 3")
    x, y = x.float().contiguous(), y.float().contiguous()
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    dev = x.device
    sched = _schedule(eps, n_iters, anneal_frac, eps0, dev)
    f = torch.empty((b, n), dtype=torch.float32, device=dev)
    g = torch.empty((b, m), dtype=torch.float32, device=dev)
    iters = torch.empty((b,), dtype=torch.int32, device=dev)
    scratch = torch.empty((3 * b,), dtype=torch.int32, device=dev)
    if g0 is not None:
        g0 = g0.float().contiguous()
        if g0.device != dev:
            raise ValueError(f"g0 on {g0.device}, points on {dev}")
    lib = _build.load("sinkhorn", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.fpsg_sinkhorn(
            x.data_ptr(), y.data_ptr(),
            None if g0 is None else g0.data_ptr(), sched.data_ptr(), b, n,
            m, int(n_iters), _t_anneal(n_iters, anneal_frac),
            _log_weight(n), _log_weight(m), float(omega),
            float(tol), f.data_ptr(), g.data_ptr(), iters.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fpsg_sinkhorn")
    count_launch(KERNEL if g0 is None else KERNEL_WARM)
    return f, g, iters


def sinkhorn_potentials(x: torch.Tensor, y: torch.Tensor, *, eps: float,
                        n_iters: int, anneal_frac: float = 0.5,
                        eps0: float = 1.0, tol: float = 0.0,
                        omega: float = 1.0,
                        g0: Optional[torch.Tensor] = None) -> Potentials:
    """Sinkhorn potentials and per-cloud iteration counts. A CUDA tensor
    launches the kernel; a CPU tensor runs the plain version.

    Without ``g0`` (K6) ``f`` and ``g`` start at 0. With ``g0`` (K11) ``g``
    starts there; ``eps0`` is then the handoff epsilon the warm start was
    made at and ``anneal_frac`` the fine stage's anneal (0: ``eps0`` at
    iteration 0 only, as in JAX)."""
    kw = dict(eps=eps, n_iters=n_iters, anneal_frac=anneal_frac, eps0=eps0,
              tol=tol, omega=omega, g0=g0)
    if on_card(x, y):
        return sinkhorn_potentials_kernel(x, y, **kw)
    return sinkhorn_potentials_plain(x, y, **kw)


def transport_cost(c: torch.Tensor, f: torch.Tensor, g: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """``<P, C>`` per batch element with ``P = exp((f + g - C) / eps +
    log_mu + log_nu)`` at the final ``eps`` (``emd.py:537-541``); ``P`` is
    detached, so the gradient flows through ``c`` alone."""
    n, m = c.shape[-2], c.shape[-1]
    log_w = float(torch.tensor(_log_weight(n), dtype=torch.float32)
                  + _log_weight(m))                   # the f32 sum
    c_sg = c.detach()
    p = torch.exp((f[..., :, None] + g[..., None, :] - c_sg) / eps + log_w)
    return (p.detach() * c).sum(dim=(-2, -1))


def coarse_warm_start(x: torch.Tensor, y: torch.Tensor, coarse: int, *,
                      eps: float, n_iters: int, anneal_frac: float,
                      eps0: float, tol: float, omega: float) -> torch.Tensor:
    """The multiscale warm start ``g0 (B, M)`` (``emd.py:461-490``): K6 on
    ``coarse`` points of each cloud, strided (not a prefix: decoder outputs
    are cluster-major), at the handoff ``eps``; then the c-transform of the
    coarse ``f`` onto the full ``y``, in torch ops."""
    n, m = x.shape[-2], y.shape[-2]
    xc = x[..., ::n // coarse, :][..., :coarse, :].contiguous()
    yc = y[..., ::m // coarse, :][..., :coarse, :].contiguous()
    fc, _, _ = sinkhorn_potentials(xc, yc, eps=eps, n_iters=n_iters,
                                   anneal_frac=anneal_frac, eps0=eps0,
                                   tol=tol, omega=omega)
    c_cy = pairwise_sqdist(xc, y)                            # (B, coarse, M)
    return -eps * _lse(((fc[..., :, None] - c_cy) / eps
                        + _log_weight(coarse)).transpose(-1, -2))


def sinkhorn_emd(x: torch.Tensor, y: torch.Tensor, *, eps: float = 2e-4,
                 n_iters: int = 360, cost: str = "sqeuclidean",
                 reduce: Optional[str] = None, anneal_frac: float = 0.5,
                 eps0: float = 0.1, tol: float = DEFAULT_TOL,
                 omega: float = DEFAULT_OMEGA, coarse: int = 0,
                 coarse_iters: int = 360, coarse_handoff: float = 0.01,
                 fine_anneal_frac: float = 0.4) -> torch.Tensor:
    """Sinkhorn-approximate EMD between point clouds ``x (B, N, D)`` and
    ``y (B, M, D)`` (2-D inputs are one batch element), with the JAX
    package's arguments and defaults (``emd.py:353-548``; its docstring
    gives their measured accuracy). ``reduce``: None -> ``(B,)``, "sum" or
    "mean" over the batch."""
    if x.dim() == 2:
        x = x[None]
    if y.dim() == 2:
        y = y[None]
    n, m = x.shape[-2], y.shape[-2]
    c = pairwise_sqdist(x, y)
    if cost == "euclidean":
        c = torch.sqrt(torch.clamp_min(c, 1e-12))
    elif cost != "sqeuclidean":
        raise ValueError(f"unknown ground cost: {cost}")

    if cost == "sqeuclidean":
        xs, ys = x.detach().float(), y.detach().float()
        kw = dict(tol=tol, omega=omega)
        if coarse > 0 and n >= 4 * coarse and m >= 4 * coarse:
            eps_mid = coarse_handoff if coarse_handoff > 0.0 else eps
            g0 = coarse_warm_start(xs, ys, coarse, eps=eps_mid,
                                   n_iters=coarse_iters,
                                   anneal_frac=anneal_frac, eps0=eps0, **kw)
            f, g, _ = sinkhorn_potentials(
                xs, ys, eps=eps, n_iters=n_iters, eps0=eps_mid,
                anneal_frac=fine_anneal_frac, g0=g0, **kw)
        else:
            f, g, _ = sinkhorn_potentials(
                xs, ys, eps=eps, n_iters=n_iters, anneal_frac=anneal_frac,
                eps0=eps0, **kw)
    else:
        sched = _schedule(eps, n_iters, anneal_frac, eps0, c.device)
        f, g, _ = _iterate(c.detach(), None, sched,
                           _t_anneal(n_iters, anneal_frac), float(omega),
                           float(tol), per_cloud=False)

    out = transport_cost(c, f, g, eps)
    if reduce == "sum":
        return out.sum()
    if reduce == "mean":
        return out.mean()
    return out


def emd_wrapper(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """The reference's ``emd_wrapper`` (``utils.py:12-13``): the default
    call summed over the batch."""
    return sinkhorn_emd(pc1, pc2, reduce="sum")
