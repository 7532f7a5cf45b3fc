"""The configuration fields the serving path, the training step and the
evaluator read.

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

    # episodic training
    n_shot: int = 20
    n_query: int = 0             # 0 -> n_shot (trainNetwork.py:71)
    support_factor: float = 1.0
    query_factor: float = 1.0
    intra_recon: bool = False
    pc_dist: str = "cd"
    n_episode: int = 100         # episodes per epoch: the StepLR epoch
    lr: float = 1e-3
    lr_decay: int = 350          # epochs per halving of lr (StepLR)
    episodes_per_step: int = 1
    steps_per_call: int = 0      # optimizer steps per dispatch (0 = auto)
    precise_stats: bool = False  # two-pass BN variance everywhere
    bf16_moments: bool = False   # Adam moments stored bf16
    dp: int = 1                  # data-parallel mesh size
    mp: int = 1                  # model-parallel mesh size

    # evaluation
    sequential_eval: bool = False  # every test item once as the query
    eval_episodes: int = 100     # random-sampler eval episodes
    eval_chunk: int = 16         # episodes per eval call (the largest
                                 # divisor of eval_episodes <= this)
    seq_eval_chunk: int = 8      # sequential eval: test items per call

    @property
    def effective_n_query(self) -> int:
        return self.n_shot if self.n_query == 0 else self.n_query

    @property
    def num_points(self) -> int:
        return self.num_pts
