"""Synthetic episode corpus generated on the device
(counterpart of ``fpsg_tpu/data/synthetic.py:synthetic_device_corpus``).

Per-class superquadric-like surfaces (gaussian directions normalized by a
class-dependent p-norm: p = 2 is a sphere, larger p approaches a cube),
scale and jitter augmentation, unit-ball normalization, and an orthographic
depth-shaded splat as the image, so the image predicts the geometry. Shapes,
dtypes and value ranges are those of the JAX version; the draws are
``torch.Generator``'s, not the JAX PRNG's.
"""

from __future__ import annotations

import torch

from fpsg_torch.data.corpus import DeviceCorpus

SHAPES = ("cube", "sphere", "cylinder", "pyramid", "torus")


def _render(pts: torch.Tensor, h: int) -> torch.Tensor:
    """(K, N, 3) clouds -> (K, h, h, 3) uint8 splats: 255 background, the
    darkest point wins a pixel, shade 40..200 by depth."""
    k = pts.shape[0]
    uv = ((pts[..., :2] * 0.4 + 0.5) * (h - 1)).int().clamp(0, h - 1)
    z = pts[..., 2]
    zmin = z.amin(dim=1, keepdim=True)
    ptp = z.amax(dim=1, keepdim=True) - zmin
    shade = (z - zmin) / (ptp + 1e-9) * 160.0 + 40.0
    flat = torch.full((k, h * h), 255.0, device=pts.device)
    flat.scatter_reduce_(1, (uv[..., 1] * h + uv[..., 0]).long(), shade,
                         reduce="amin")
    img = flat.to(torch.uint8).reshape(k, h, h, 1)
    return img.expand(k, h, h, 3).contiguous()


def synthetic_device_corpus(n_classes: int = 2, items_per_class: int = 48,
                            n_pts: int = 2048, img_size: int = 224,
                            seed: int = 0, jitter: float = 0.05,
                            device="cuda") -> DeviceCorpus:
    """A :class:`DeviceCorpus` made on ``device`` from ``seed``: images
    (C, M, img, img, 3) uint8, clouds (C, M, n_pts, 3) f32 in the unit
    ball, every item valid and eligible."""
    c, m, n = n_classes, items_per_class, n_pts
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn((c, m, n, 3), generator=g, device=device)
    p = (2.0 * (1.0 + torch.arange(c, device=device, dtype=torch.float32))
         ).reshape(c, 1, 1, 1)
    norm = (v.abs() ** p).sum(dim=-1, keepdim=True) ** (1.0 / p)
    pts = v / norm.clamp_min(1e-12)
    scale = 0.7 + 0.3 * torch.rand((c, m, 1, 1), generator=g, device=device)
    pts = pts * scale + jitter * torch.randn(pts.shape, generator=g,
                                             device=device)
    pts = pts - pts.mean(dim=2, keepdim=True)
    r = pts.norm(dim=-1).amax(dim=-1)[..., None, None]
    pts = pts / r.clamp_min(1e-12)
    images = _render(pts.reshape(c * m, n, 3), img_size).reshape(
        c, m, img_size, img_size, 3)
    counts = torch.full((c,), m, dtype=torch.int32, device=device)
    names = tuple(SHAPES[i % len(SHAPES)]
                  + (f"_{i // len(SHAPES)}" if i >= len(SHAPES) else "")
                  for i in range(c))
    return DeviceCorpus(images=images, clouds=pts.float(), counts=counts,
                        episode_counts=counts.clone(), class_names=names)
