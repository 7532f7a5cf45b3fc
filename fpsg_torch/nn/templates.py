"""Template surfaces for the shape-primitive decoder
(counterpart of ``fpsg_tpu/nn/templates.py``).

Random draws come from an explicit ``torch.Generator``, on that
generator's device; they are not the JAX PRNG's bits, so parity tests pass
template points in explicitly.
Regular points are numpy, copied from the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _device(generator: Optional[torch.Generator]) -> Optional[torch.device]:
    return generator.device if generator is not None else None


class SquareTemplate:
    """Uniform samples on the unit square [0,1)^2."""

    dim = 2

    @staticmethod
    def get_random_points(shape: Sequence[int],
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        """shape is (..., dim=2) points-last; returns uniform [0,1) f32."""
        return torch.rand(tuple(shape), generator=generator,
                          dtype=torch.float32, device=_device(generator))

    @staticmethod
    def get_regular_points(npoints: int = 2048) -> np.ndarray:
        """Regular grid on the unit square, (grain+1)^2 vertices."""
        grain = int(np.sqrt(npoints)) - 1
        ii, jj = np.meshgrid(
            np.arange(grain + 1), np.arange(grain + 1), indexing="ij"
        )
        verts = np.stack([ii / grain, jj / grain], axis=-1).reshape(-1, 2)
        return verts.astype(np.float32)


class SphereTemplate:
    """Gaussian directions normalized to the unit sphere."""

    dim = 3

    @staticmethod
    def get_random_points(shape: Sequence[int],
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        g = torch.randn(tuple(shape), generator=generator,
                        dtype=torch.float32, device=_device(generator))
        return g / torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True) + 1e-12)

    @staticmethod
    def get_regular_points(subdiv: int = 4) -> np.ndarray:
        return icosphere_vertices(subdiv)


def icosphere_vertices(subdiv: int) -> np.ndarray:
    """Unit icosphere vertices by repeated edge subdivision (numpy)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdiv):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k not in edge_mid:
                m = (vlist[a] + vlist[b]) / 2.0
                m /= np.linalg.norm(m)
                edge_mid[k] = len(vlist)
                vlist.append(m)
            return edge_mid[k]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, np.int64)
    return verts.astype(np.float32)


_TEMPLATES = {"SQUARE": SquareTemplate, "SPHERE": SphereTemplate}


def get_template(template_type: str):
    try:
        return _TEMPLATES[template_type]
    except KeyError:
        raise ValueError(f"Invalid template: {template_type}")
