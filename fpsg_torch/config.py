"""The configuration fields the serving path reads.

A copy of the matching ``FPSGConfig`` fields of ``fpsg_tpu/config.py``
(same names and defaults); the port keeps its own so that it never
imports the JAX package. Fields join as the slices that read them are
ported.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FPSGConfig:
    img_encoder: str = "vgg_16"
    pc_encoder: str = "pointnet"
    num_clusters: int = 4
    num_nodes: int = 4
    ori_dim: int = 2
    raw_dim: int = 3
    bottleneck_size: int = 1536
    template_type: str = "SQUARE"
    activation: str = "relu"
    aggregate: str = "single"
    seed: int = 0
    num_pts: int = 2048          # points per generated cloud
    compute_dtype: str = "f32"   # 'f32' or 'bf16' (params and BN stats
                                 # stay f32)

    @property
    def num_points(self) -> int:
        return self.num_pts
