#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, training steps and evaluator on
one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. build: every kernel of ``fpsg_torch/csrc`` built by ``nvcc`` (sm_90a),
   one process per source, all started together.
3. kernels: each kernel against its plain PyTorch version on the card,
   f32 and bf16 where the kernel takes both. At the serving shapes (Q = 8
   images of 224x224; decoder C = Nn = 4, R = 8 x 128 rows): the max-pool
   bitwise (values and first-match codes, with forced ties), the decoder
   layers within ``F32_TOL`` / ``BF16_TOL`` of the output scale. At the
   training shapes (33 images; Chamfer at B = 1 and B = 32 clouds of 2048
   points): the max-pool and its backward bitwise, the Chamfer nearest
   neighbour bitwise (indices and distances, with duplicated points forcing
   ties), the segment sum within ``SEGSUM_TOL``; the single-read
   statistics kernels at the step's shapes (K3 at 64 clouds x 2048 points
   x 1024 channels, K4 at the five VGG BN -> pool sites of 33 images) in
   f32 and bf16 on quantized inputs (forced ties): max/min values,
   indices, codes and both backwards bitwise, the shifted sums within
   ``STAT_SUM_TOL``; the decoder's training kernels (K5d/K5a with
   statistics, K5e, K5b, K5c, K5g) at both decoder passes of the step
   (B = 1 and B = 32 clouds of 128 points a node, 16 nodes) in f32 and
   bf16 with forced relu ties: outputs within ``F32_TOL`` of their scale
   (bf16: one bf16 ulp plus that), sums within ``STAT_SUM_TOL``, relu
   masks identical. Times by CUDA events (median of repeats) for the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (``F.max_pool2d``,
   ``max_pool2d_with_indices_backward``, ``index_add_``; ``torch.bmm`` of
   the mid layers' product alone: forward, dx and dW on the already
   activated or adjusted operands; none for K3, K4, K5d, K5e, K5g).
   The Sinkhorn solves (unit-ball clouds of 2048 points): K6 at the
   evaluator's settings at B = 1 and B = 16 (four easy pairs in the 16,
   so that clouds exit at different iterations), at the emd training
   loss's at B = 1 and 32, and at tol = 0; K11 at B = 2 on the warm start
   of ``coarse = 256``: potentials within ``SINKHORN_POT_TOL`` of their
   scale, values within ``SINKHORN_RTOL`` / ``SINKHORN_ATOL``, per-cloud
   iteration counts within ``SINKHORN_ITERS_TOL``; bound: the solve's
   exponentials at the ex2 rate (16 a clock per SM at the maximum SM
   clock). Then the multiscale path, ``sinkhorn_emd(coarse=256)``, with
   counts reset just before: K6 once, K11 once.
4. serve: ``Generator`` at the flagship width (VGG16-bn at 224x224,
   PointNet over 32 support clouds of 2048 points, 4x4 decoder, 2048
   points, random weights from a seed, f32): ``prototype`` once, then 5
   requests of 8 uint8 images. Launch counts reset just before and read
   just after; each request must launch the pool 5 times, fused_l1 once,
   fused_mid twice and fused_out once. Outputs (8, 2048, 3), finite, in
   [-1, 1].
5. profile: one more request under ``torch.profiler``: device time by
   kernel group and the device's busy share of the request.
6. plain: the same weights, inputs and template points through the port
   on the CPU (the plain versions); max abs difference within
   ``PATH_TOL``. Then ``stream`` against per-call on the card, and one
   bf16 request (finite, in range).
7. train: the episodic training step at the flagship width
   (``fpsg_torch.train``; 1-way, 32 support, 1 query, 32 ad items,
   intra-support reconstruction, ``precise_stats``, f32, Adam at 1e-3) on
   a synthetic corpus of 2 classes x 48 items made on the card from a
   seed: ``init_state``, then 1 warm and ``TRAIN_STEPS`` timed steps on the
   host clock, each ending in a sync. Launch counts reset just before the
   warm step and read just after the last; each step must launch the pool
   and its backward 5 times, the Chamfer kernel twice and the segment sum
   4 times, and no single-read statistics kernel. Losses finite.
8. train profile: one more step under ``torch.profiler`` (device time by
   kernel group, busy share).
9. train plain: one step at a reduced size (8 support, 64x64 images,
   512 points, the full-width decoder) on the card and on the CPU from the
   same weights, episode and template points: losses, a gradient sample
   and the running statistics within the ``TRAIN_*_TOL`` bounds.
10. train single-read: the same episode with single-read BatchNorm
   statistics and bf16 compute, the decoder's unfused chain
   (``decoder_fused="off"``) and f32 Adam moments, at the flagship width:
   ``init_state``, 1 warm and ``TRAIN_STEPS`` timed steps (and the host's
   time to return from each step call, before the sync); each step must
   launch K4f and K4b 5 times, K3f and K3b twice, the Chamfer kernel
   twice, the segment sum 4 times and no max-pool or K5 kernel. Losses
   finite; peak memory.
11. single-read profile: one more such step under ``torch.profiler``.
12. single-read plain: one step at the reduced size in f32 and in bf16 on
   the card and on the CPU (``SR_*`` bounds).
13. train bench: ``bench.py``'s configuration, the single-read bf16 step
   with the decoder's fused chain (``decoder_fused`` on ``auto``, so on),
   bf16 Adam moments and ``steps_per_call=8``: 1 warm and
   ``TRAIN_STEPS`` timed calls of 8 optimizer steps; per optimizer step
   the launches of phase 10 plus K5d and K5e twice, K5a, K5b and K5c 4
   times, K5f and K5g twice (``PER_STEP_BENCH``).
14. bench profile: one more call under ``torch.profiler``.
15. bench plain: phase 12 with the fused chain on both sides (the CPU's
   forced ``"on"``).
16. eval: the evaluator at ``benchmarks/eval_bench.py:34-45``'s
   configuration (1-way 32-shot, Q = 1, ``intra_support``, 224x224
   images, 2048 points, bf16, random weights from a seed) on the synthetic
   corpus: 1 warm and ``EVAL_CALLS`` timed calls of ``episodic_eval`` (32
   episodes in chunks of 16) with EMD and without; per chunk K6 once, K1
   once, the serving kernels once, no training kernel
   (``PER_CHUNK_EVAL``; without EMD the loss's two decoder passes and two
   Chamfer distances). Episodes/s, the per-class lines of ``evaluate``,
   16 items of ``run_sequential``; running statistics unchanged.
17. eval profile: one chunk with EMD under ``torch.profiler``, the EMD's
   share of the call; one chunk without EMD.
18. eval plain: ``reconstruct`` at the reduced size on the card and on
   the CPU: CD and clouds within ``PATH_TOL``, EMD within the K6 bound.
19. train emd: phase 13 with ``pc_dist="emd"``: per optimizer step K6
   twice (B = 1 and 32), no K1 or K2 (``PER_STEP_EMD``).
20. emd profile: one more call under ``torch.profiler``.
21. emd plain: phase 15 with ``pc_dist="emd"``.
22. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``, the profiles' per-kernel
device times to ``chiprun_out/chip_smoke_profile*.txt`` and the compiler's
``-Xptxas -v`` report to ``chiprun_out/chip_smoke_build.log``.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from fpsg_torch import ops
from fpsg_torch.config import FPSGConfig
from fpsg_torch.data.corpus import sample_episode, sample_episode_batch
from fpsg_torch.data.synthetic import synthetic_device_corpus
from fpsg_torch.models import ImgPCProtoNet, build_model
from fpsg_torch.nn import fused_stack as fs
from fpsg_torch.ops import _build
from fpsg_torch.ops import emd
from fpsg_torch.ops.chamfer import nn_both, nn_both_plain
from fpsg_torch.ops.moments import (
    moments_bwd, moments_bwd_plain, moments_fwd, moments_fwd_plain,
)
from fpsg_torch.ops.pool import (
    maxpool2x2, maxpool2x2_bwd, maxpool2x2_bwd_plain, maxpool2x2_plain,
)
from fpsg_torch.ops.pool_moments import (
    pool_moments_bwd, pool_moments_bwd_plain, pool_moments_fwd,
    pool_moments_fwd_plain,
)
from fpsg_torch.ops.scatter import segment_sum, segment_sum_plain
from fpsg_torch.serve import Generator
from fpsg_torch.train import (
    episodic_eval, evaluate, init_model, init_state, make_eval_step,
    make_train_step, run_sequential,
)

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
SEED = 0
Q, IMG, SUPPORT, NPTS, CALLS = 8, 224, 32, 2048, 5
POOL_SHAPES = [(Q, 224, 224, 64), (Q, 112, 112, 128), (Q, 56, 56, 256),
               (Q, 28, 28, 512), (Q, 14, 14, 512)]
C, NN, D0 = 4, 4, 1539                     # clusters, nodes, d_node
R = Q * (NPTS // C // NN)                  # rows per (cluster, node)
MID_SHAPES = [(D0, D0 // 2), (D0 // 2, D0 // 4)]   # 1539->769, 769->384
PER_CALL = {"maxpool2x2": 5, "fused_l1": 1, "fused_mid": 2, "fused_out": 1,
            "fused_l1_stats": 0, "fused_mid_stats": 0, "fused_mid_dx": 0,
            "fused_mid_dw": 0, "fused_l1_bwd": 0, "fused_out_bwd": 0,
            "sinkhorn": 0, "sinkhorn_warm": 0}
# training: 32 support + 32 ad clouds, 32 ad + 1 query images
S_TR, Q_TR, TRAIN_STEPS = 32, 1, 5
B_IMG = S_TR + Q_TR
TRAIN_POOL_SHAPES = [(B_IMG, 224, 224, 64), (B_IMG, 112, 112, 128),
                     (B_IMG, 56, 56, 256), (B_IMG, 28, 28, 512),
                     (B_IMG, 14, 14, 512)]
STAT_KERNELS = ("moments_fwd", "moments_bwd", "pool_moments_fwd",
                "pool_moments_bwd")
# the decoder's training kernels: K5d/K5a with statistics, K5b/K5c/K5e/K5g
K5_TRAIN = ("fused_l1_stats", "fused_mid_stats", "fused_mid_dx",
            "fused_mid_dw", "fused_l1_bwd", "fused_out_bwd")
PER_STEP = {"maxpool2x2": 5, "maxpool2x2_bwd": 5, "chamfer_nn": 2,
            "segment_sum": 4, "fused_l1": 0, "fused_mid": 0, "fused_out": 0,
            **{k: 0 for k in STAT_KERNELS}, **{k: 0 for k in K5_TRAIN},
            "sinkhorn": 0, "sinkhorn_warm": 0}
# single-read statistics (bench.py's configuration): K3 at the two PointNet
# BN -> max sites, K4 at the five VGG BN -> pool sites, no K7
PER_STEP_SR = {**PER_STEP, "maxpool2x2": 0, "maxpool2x2_bwd": 0,
               "moments_fwd": 2, "moments_bwd": 2, "pool_moments_fwd": 5,
               "pool_moments_bwd": 5}
# bench.py's configuration: the same plus the decoder's fused node chain in
# both passes (query and ad), forward and backward
PER_STEP_BENCH = {**PER_STEP_SR, "fused_l1_stats": 2, "fused_mid_stats": 4,
                  "fused_out": 2, "fused_out_bwd": 2, "fused_mid_dx": 4,
                  "fused_mid_dw": 4, "fused_l1_bwd": 2}
BENCH_K = 8                                 # bench.py --steps-per-call
# --pc_dist emd in bench.py's configuration: per optimizer step one
# Sinkhorn solve per decoder pass (B = 1 and B = 32) instead of K1 and K2
PER_STEP_EMD = {**PER_STEP_BENCH, "chamfer_nn": 0, "segment_sum": 0,
                "sinkhorn": 2, "sinkhorn_warm": 0}
# the evaluator (reconstruct, eval mode): per chunk of episodes one VGG
# pass (5 pools), the decoder's eval kernels once, K1 once and K6 once;
# no training kernel. Without EMD (the loss in eval mode): two decoder
# passes and two Chamfer distances, no K6.
NO_TRAIN = {k: 0 for k in ("maxpool2x2_bwd", "segment_sum", *STAT_KERNELS,
                           *K5_TRAIN, "sinkhorn_warm")}
PER_CHUNK_EVAL = {**NO_TRAIN, "maxpool2x2": 5, "fused_l1": 1, "fused_mid": 2,
                  "fused_out": 1, "chamfer_nn": 1, "sinkhorn": 1}
PER_CHUNK_EVAL_NO_EMD = {**PER_CHUNK_EVAL, "fused_l1": 2, "fused_mid": 4,
                         "fused_out": 2, "chamfer_nn": 2, "sinkhorn": 0}
# eval: benchmarks/eval_bench.py:34-45 (1-way 32-shot, Q = 1, bf16), 32
# episodes a call in chunks of 16, 16 items of the sequential pass
EVAL_EPISODES, EVAL_CHUNK, EVAL_CALLS, SEQ_ITEMS = 32, 16, 3, 16
# Sinkhorn (K6/K11) against its plain version: values within the JAX
# package's own pallas-vs-oracle bound (tests/test_ops_emd.py:77-82);
# potentials within SINKHORN_POT_TOL of their scale (exp2f and another
# summation order than the plain version's exp); per-cloud iteration
# counts within SINKHORN_ITERS_TOL (a delta near tol can cross it an
# iteration earlier or later)
SINKHORN_RTOL, SINKHORN_ATOL = 1e-3, 1e-5
SINKHORN_POT_TOL, SINKHORN_ITERS_TOL = 1e-4, 2
EVAL_DEFAULTS = dict(eps=2e-4, n_iters=360, anneal_frac=0.5, eps0=0.1,
                     tol=emd.DEFAULT_TOL, omega=emd.DEFAULT_OMEGA)
TRAIN_EMD = dict(EVAL_DEFAULTS, eps=0.01, n_iters=100)   # protonet._pc_dist
MUFU_EX2_PER_CLOCK_SM, SMS = 16, 132       # H100 SXM: ex2 a clock per SM
PPN = NPTS // C // NN                      # points per node: 128
DEC_BATCHES = (Q_TR, S_TR)                 # the query and the ad pass
MOMENTS_SHAPE = (2 * S_TR, NPTS, 1024)     # [support ‖ ad] clouds, conv3
# K3/K4 sums: f32 sums of up to 1.3e8 terms in another order than the plain
# version's, relative to the largest |sum|
STAT_SUM_TOL = 1e-5
# segment sum: f32 sums of a few values each; the plain version on the card
# (index_add_ with float atomics) adds them in a varying order
SEGSUM_TOL = 1e-6
# One training step, card vs CPU, reduced size. The step is ill-conditioned
# at small batch (the query decoder normalizes one cloud's rows): on the
# CPU, 1e-7 relative noise on the weights moves the losses by ~3e-5 and
# the gradients by up to 2e-2 of their max (tests/test_torch_train_step.py).
# Losses: relative; gradients: of each sampled leaf's max; running
# statistics: of each tensor's max.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_STATE_TOL = 1e-3, 5e-2, 1e-4
# The same step with single-read statistics in bf16, card vs CPU: bf16
# rounds every layer, and one-unit differences (another summation order in
# cuDNN/cuBLAS) spread through the network. Each quantity (a loss,
# relative; a gradient leaf, relative Frobenius norm; a running statistic,
# max abs) is held to SR_FACTOR x the CPU path's own bf16 rounding
# sensitivity at this seed: the larger of its bf16-vs-f32 gap and its
# change under 1e-7 relative noise on the weights.
SR_FACTOR = 3.0
# Tolerances, as max |kernel - plain| / max |plain|: f32 products summed in
# another order; bf16 outputs round once to bf16 (2^-8 relative), and a
# different summation order can move a value to the neighbouring bf16.
F32_TOL, BF16_TOL = 1e-5, 1e-2
# The decoder's training kernels (phase 3, K5_TRAIN), elementwise: f32
# outputs and every f32 sum (statistics, dk, db, dbias, dy_cond, dsc)
# within F32_TOL / STAT_SUM_TOL of the output's scale; bf16 outputs within
# one bf16 ulp of the plain value plus F32_TOL of the scale (the f32
# accumulations, in another order, can sit on either side of a rounding
# boundary; the ulp alone fails where the value cancels to near 0).
# Whole path, card vs CPU, max |card - cpu| / max |cpu|: f32 with TF32 off
# on both; cuDNN/oneDNN convs and the kernels sum in other orders.
PATH_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.float32: 67e12,          # f32 outside the tensor cores
            torch.bfloat16: 989e12}        # bf16 tensor cores, dense
SOURCES = {
    "maxpool2x2": ("fpsg_torch/csrc/maxpool2x2.cu",
                   "fpsg_tpu/nn/vgg.py:159"),
    "fused_l1": ("fpsg_torch/csrc/fused_stack.cu",
                 "fpsg_tpu/nn/fused_stack.py:533"),
    "fused_mid": ("fpsg_torch/csrc/fused_stack.cu",
                  "fpsg_tpu/nn/fused_stack.py:314"),
    "fused_out": ("fpsg_torch/csrc/fused_stack.cu",
                  "fpsg_tpu/nn/fused_stack.py:682"),
    "maxpool2x2_bwd": ("fpsg_torch/csrc/maxpool2x2.cu",
                       "fpsg_tpu/nn/vgg.py:188"),
    "chamfer_nn": ("fpsg_torch/csrc/chamfer.cu",
                   "fpsg_tpu/ops/chamfer.py:172"),
    "segment_sum": ("fpsg_torch/csrc/segment_sum.cu",
                    "fpsg_tpu/ops/scatter.py:78"),
    "moments_fwd": ("fpsg_torch/csrc/moments.cu",
                    "fpsg_tpu/ops/moments.py:119"),
    "moments_bwd": ("fpsg_torch/csrc/moments.cu",
                    "fpsg_tpu/ops/moments.py:151"),
    "pool_moments_fwd": ("fpsg_torch/csrc/pool_moments.cu",
                         "fpsg_tpu/ops/pool_moments.py:123"),
    "pool_moments_bwd": ("fpsg_torch/csrc/pool_moments.cu",
                         "fpsg_tpu/ops/pool_moments.py:160"),
    "fused_l1_stats": ("fpsg_torch/csrc/fused_stack.cu",
                       "fpsg_tpu/nn/fused_stack.py:533"),
    "fused_mid_stats": ("fpsg_torch/csrc/fused_stack.cu",
                        "fpsg_tpu/nn/fused_stack.py:314"),
    "fused_mid_dx": ("fpsg_torch/csrc/fused_stack.cu",
                     "fpsg_tpu/nn/fused_stack.py:351"),
    "fused_mid_dw": ("fpsg_torch/csrc/fused_stack.cu",
                     "fpsg_tpu/nn/fused_stack.py:371"),
    "fused_l1_bwd": ("fpsg_torch/csrc/fused_stack.cu",
                     "fpsg_tpu/nn/fused_stack.py:568"),
    "fused_out_bwd": ("fpsg_torch/csrc/fused_stack.cu",
                      "fpsg_tpu/nn/fused_stack.py:707"),
    "sinkhorn": ("fpsg_torch/csrc/sinkhorn.cu", "fpsg_tpu/ops/emd.py:241"),
    "sinkhorn_warm": ("fpsg_torch/csrc/sinkhorn.cu",
                      "fpsg_tpu/ops/emd.py:309"),
}
# the path each kernel's launches and times are read from
TRAIN_KERNELS = ("maxpool2x2", "maxpool2x2_bwd")          # precise_stats
SR_KERNELS = ("chamfer_nn", "segment_sum", *STAT_KERNELS)  # single-read


def say(phase: str, **fields) -> None:
    print(f"phase {phase}: " + json.dumps(fields), flush=True)


def cuda_ms(fn, iters: int = 10, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` launches."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound_ms(nbytes: float, nops: float, dtype) -> tuple:
    """Least time for the work: the larger of bytes over HBM bandwidth and
    operations over the peak rate for the dtype; and which bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


# -- phase 3: kernels against their plain versions -------------------------

def check_pool(dtype, gen, shapes=POOL_SHAPES) -> list:
    rows = []
    for shape in shapes:
        # quantized values: many windows hold ties for the maximum
        x = (torch.randn(shape, generator=gen, device=gen.device) * 4) \
            .round().div(4)
        x = x.to(dtype).cuda()
        y, code = maxpool2x2(x, return_index=True)
        ry, rcode = maxpool2x2_plain(x)
        if not (torch.equal(y, ry) and torch.equal(code, rcode)):
            raise AssertionError(f"maxpool2x2 {shape} {dtype}: not bitwise "
                                 "equal to the plain version")
        xn = x.permute(0, 3, 1, 2)             # NCHW view, channels_last
        b, t = bound_ms(nbytes(x, y), 3 * y.numel(), dtype)
        rows.append({
            "shape": list(shape), "max_abs_err": 0.0, "bound_ms": b,
            "bound_by": t, "ms": cuda_ms(lambda: maxpool2x2(x)),
            "plain_ms": cuda_ms(lambda: maxpool2x2_plain(x)),
            "library_ms": cuda_ms(lambda: F.max_pool2d(xn, 2)),
        })
    return rows


def check_fused(dtype, gen) -> dict:
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dt).cuda()

    def verify(name, got, ref):
        err, rel = rel_err(got, ref)
        if not rel <= tol:
            raise AssertionError(f"{name} {dtype}: max abs err {err} "
                                 f"({rel} of the output scale) > {tol}")
        return err

    out = {"fused_l1": [], "fused_mid": [], "fused_out": []}
    # layer 1: y = d @ Wd + y_cond
    d = rnd(C, NN, R, 3, dt=dtype).tanh()
    wd = rnd(C, NN, 3, D0, scale=0.3, dt=dtype)
    yc = rnd(C, NN, Q, D0)
    y = fs.fused_l1_layer(d, wd, yc, R // Q)
    b, t = bound_ms(nbytes(d, wd, yc, y), 2 * y.numel() * 3, dtype)
    out["fused_l1"].append({
        "shape": [C, NN, R, 3, D0], "bound_ms": b, "bound_by": t,
        "max_abs_err": verify("fused_l1", y,
                              fs.fused_l1_plain(d, wd, yc, R // Q)),
        "ms": cuda_ms(lambda: fs.fused_l1_layer(d, wd, yc, R // Q)),
        "plain_ms": cuda_ms(lambda: fs.fused_l1_plain(d, wd, yc, R // Q)),
        "library_ms": None,
    })
    # mid layers: y = relu(k * yp + b) @ W, at both serving shapes
    yp = y
    for din, dout in MID_SHAPES:
        k = 0.5 + torch.rand((C, NN, din), generator=gen).cuda()
        bb = rnd(C, NN, din, scale=0.3)
        w = rnd(C, NN, din, dout, scale=din ** -0.5, dt=dtype)
        y = fs.fused_mid_layer(yp, k, bb, w)
        a = fs._affine_relu(yp, k, bb).reshape(C * NN, R, din)
        w3 = w.reshape(C * NN, din, dout)
        b, t = bound_ms(nbytes(yp, k, bb, w, y), 2 * C * NN * R * din * dout,
                        dtype)
        out["fused_mid"].append({
            "shape": [C, NN, R, din, dout], "bound_ms": b, "bound_by": t,
            "max_abs_err": verify("fused_mid", y,
                                  fs.fused_mid_plain(yp, k, bb, w)),
            "ms": cuda_ms(lambda: fs.fused_mid_layer(yp, k, bb, w)),
            "plain_ms": cuda_ms(lambda: fs.fused_mid_plain(yp, k, bb, w)),
            "library_ms": cuda_ms(lambda: torch.bmm(a, w3)),
        })
        yp = y
    # output layer: tanh(relu(k * yp + b) @ W + bias), f32
    din = yp.shape[-1]
    k = 0.5 + torch.rand((C, NN, din), generator=gen).cuda()
    bb = rnd(C, NN, din, scale=0.3)
    w = rnd(C, NN, din, 3, scale=din ** -0.5, dt=dtype)
    bias = rnd(C, NN, 3, scale=0.1)
    y = fs.fused_out_layer(yp, k, bb, w, bias)
    b, t = bound_ms(nbytes(yp, k, bb, w, bias, y), 2 * y.numel() * din,
                    dtype)
    out["fused_out"].append({
        "shape": [C, NN, R, din, 3], "bound_ms": b, "bound_by": t,
        "max_abs_err": verify("fused_out", y,
                              fs.fused_out_plain(yp, k, bb, w, bias)),
        "ms": cuda_ms(lambda: fs.fused_out_layer(yp, k, bb, w, bias)),
        "plain_ms": cuda_ms(lambda: fs.fused_out_plain(yp, k, bb, w, bias)),
        "library_ms": None,
    })
    return out


def check_pool_bwd(dtype, gen) -> list:
    """K7b at the five training pool sites, bitwise against the plain
    version, on codes from K7f over inputs with forced ties."""
    rows = []
    for shape in TRAIN_POOL_SHAPES:
        x = (torch.randn(shape, generator=gen, device="cuda") * 4).round() \
            .div(4).to(dtype)
        _, code = maxpool2x2(x, return_index=True)
        g = torch.randn((shape[0], shape[1] // 2, shape[2] // 2, shape[3]),
                        generator=gen, device="cuda").to(dtype)
        gx = maxpool2x2_bwd(g, code)
        if not torch.equal(gx, maxpool2x2_bwd_plain(g, code)):
            raise AssertionError(f"maxpool2x2_bwd {shape} {dtype}: not "
                                 "bitwise equal to the plain version")
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        _, ind = F.max_pool2d(xn, 2, return_indices=True)
        b, t = bound_ms(nbytes(g, code, gx), 0, dtype)
        rows.append({
            "shape": list(shape), "max_abs_err": 0.0, "bound_ms": b,
            "bound_by": t, "calls": 1,
            "ms": cuda_ms(lambda: maxpool2x2_bwd(g, code)),
            "plain_ms": cuda_ms(lambda: maxpool2x2_bwd_plain(g, code)),
            "library_ms": cuda_ms(
                lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                    gn, xn, [2, 2], [2, 2], [0, 0], [1, 1], False, ind)),
        })
        del x, code, g, gx, xn, gn, ind
    return rows


def check_chamfer(gen) -> dict:
    """K1 and K2 at the step's shapes: the query pass (B = 1) and the ad
    pass (B = 32), 2048 points each. Per step each B runs K1 once and K2
    twice (one push per direction)."""
    rows = {"chamfer_nn": [], "segment_sum": []}
    for b in (Q_TR, S_TR):
        x = 0.5 * torch.randn((b, NPTS, 3), generator=gen, device="cuda")
        y = 0.5 * torch.randn((b, NPTS, 3), generator=gen, device="cuda")
        y[:, 16:32] = y[:, 0:16]            # duplicates: exact ties
        x[:, 48:64] = x[:, 0:16]
        got = nn_both(x, y)
        ref = nn_both_plain(x, y)
        if not all(torch.equal(u, v) for u, v in zip(got, ref)):
            raise AssertionError(f"chamfer_nn B={b}: not bitwise equal to "
                                 "the plain version")
        if ((got[1] >= 16) & (got[1] < 32)).any() or \
                ((got[3] >= 48) & (got[3] < 64)).any():
            raise AssertionError(f"chamfer_nn B={b}: a tie went to a "
                                 "later index")
        # 10 operations per pair: 3 products, 2 adds (dot), 2x, subtract,
        # add, clamp; then one compare in each direction
        pairs = b * NPTS * NPTS
        bnd, by = bound_ms(nbytes(x, y, *got), 10 * pairs, torch.float32)
        rows["chamfer_nn"].append({
            "shape": [b, NPTS, NPTS], "max_abs_err": 0.0, "bound_ms": bnd,
            "bound_by": by, "calls": 1,
            "ms": cuda_ms(lambda: nn_both(x, y)),
            "plain_ms": cuda_ms(lambda: nn_both_plain(x, y)),
            "library_ms": None,
        })
        vals = torch.randn((b, NPTS, 3), generator=gen, device="cuda")
        idx = got[1]
        out = segment_sum(vals, idx, NPTS)
        err, rel = rel_err(out, segment_sum_plain(vals, idx, NPTS))
        if not rel <= SEGSUM_TOL:
            raise AssertionError(f"segment_sum B={b}: max abs err {err} "
                                 f"({rel} of the output scale)")
        flat = (idx.long() + NPTS * torch.arange(b, device="cuda")[:, None]
                ).reshape(-1)
        v2 = vals.reshape(-1, 3)
        bnd, by = bound_ms(nbytes(vals, idx, out), vals.numel(),
                           torch.float32)
        rows["segment_sum"].append({
            "shape": [b, NPTS, NPTS, 3], "max_abs_err": err,
            "bound_ms": bnd, "bound_by": by, "calls": 2,
            "ms": cuda_ms(lambda: segment_sum(vals, idx, NPTS)),
            "plain_ms": cuda_ms(lambda: segment_sum_plain(vals, idx, NPTS)),
            "library_ms": cuda_ms(lambda: torch.zeros(
                (b * NPTS, 3), device="cuda").index_add_(0, flat, v2)),
        })
    return rows


def _quantized(shape, gen, dtype):
    """Values on a 0.25 grid: many exact ties for maxima and minima."""
    return (torch.randn(shape, generator=gen, device="cuda") * 4).round() \
        .div(4).to(dtype)


def _check_stat_kernel(name, got, ref, sums=2):
    """Sums within STAT_SUM_TOL of their scale, the rest bitwise; returns
    the sums' max abs error."""
    err = 0.0
    for k, (u, v) in enumerate(zip(got, ref)):
        if k < sums:
            e, rel = rel_err(u, v)
            if not rel <= STAT_SUM_TOL:
                raise AssertionError(f"{name}: sum {k} off by {e} ({rel} of "
                                     f"its scale) > {STAT_SUM_TOL}")
            err = max(err, e)
        elif not torch.equal(u, v):
            raise AssertionError(f"{name}: output {k} not bitwise equal to "
                                 "the plain version")
    return err


def check_moments(dtype, gen) -> dict:
    """K3f and K3b at the PointNet conv3 shape, both per step twice."""
    b, n, f = MOMENTS_SHAPE
    y = _quantized((b, n, f), gen, dtype)
    s = 0.1 * torch.randn(f, generator=gen, device="cuda")
    got, ref = moments_fwd(y, s), moments_fwd_plain(y, s)
    err = _check_stat_kernel(f"moments_fwd {dtype}", got, ref)
    if not (got[3] < n).all():
        raise AssertionError("moments_fwd: index out of range")
    cot = [0.1 * torch.randn(f, generator=gen, device="cuda") for _ in "ab"]
    cot += [torch.randn((b, f), generator=gen, device="cuda") for _ in "ab"]
    args = (y, s, cot[0], cot[1], cot[2], got[3], cot[3], got[5])
    gy = moments_bwd(*args)
    if not torch.equal(gy, moments_bwd_plain(*args)):
        raise AssertionError(f"moments_bwd {dtype}: not bitwise equal to "
                             "the plain version")
    # per element: subtract, add, multiply-add, two compares (f32 units)
    fb, fby = bound_ms(nbytes(y, s, *got), 5 * y.numel(), torch.float32)
    bb, bby = bound_ms(nbytes(*args, gy), 4 * y.numel(), torch.float32)
    shape = [b, n, f]
    return {
        "moments_fwd": [{
            "shape": shape, "max_abs_err": err, "bound_ms": fb,
            "bound_by": fby, "calls": 2,
            "ms": cuda_ms(lambda: moments_fwd(y, s)),
            "plain_ms": cuda_ms(lambda: moments_fwd_plain(y, s), iters=3),
            "library_ms": None}],
        "moments_bwd": [{
            "shape": shape, "max_abs_err": 0.0, "bound_ms": bb,
            "bound_by": bby, "calls": 2,
            "ms": cuda_ms(lambda: moments_bwd(*args)),
            "plain_ms": cuda_ms(lambda: moments_bwd_plain(*args), iters=3),
            "library_ms": None}],
    }


def check_pool_moments(dtype, gen) -> dict:
    """K4f and K4b at the five VGG BN -> pool sites (packed view)."""
    rows = {"pool_moments_fwd": [], "pool_moments_bwd": []}
    for b, h, w, c in TRAIN_POOL_SHAPES:
        y = _quantized((b, h, w // 2, 2 * c), gen, dtype)
        s = 0.1 * torch.randn(c, generator=gen, device="cuda")
        got, ref = pool_moments_fwd(y, s), pool_moments_fwd_plain(y, s)
        err = _check_stat_kernel(f"pool_moments_fwd {(b, h, w, c)} {dtype}",
                                 got, ref)
        del ref
        pooled = (b, h // 2, w // 2, c)
        args = (y, s, 0.1 * torch.randn(c, generator=gen, device="cuda"),
                0.1 * torch.randn(c, generator=gen, device="cuda"),
                torch.randn(pooled, generator=gen, device="cuda").to(dtype),
                got[3],
                torch.randn(pooled, generator=gen, device="cuda").to(dtype),
                got[5])
        gy = pool_moments_bwd(*args)
        if not torch.equal(gy, pool_moments_bwd_plain(*args)):
            raise AssertionError(f"pool_moments_bwd {(b, h, w, c)} {dtype}: "
                                 "not bitwise equal to the plain version")
        fb, fby = bound_ms(nbytes(y, s, *got), 5 * y.numel(), torch.float32)
        bb, bby = bound_ms(nbytes(*args, gy), 4 * y.numel(), torch.float32)
        rows["pool_moments_fwd"].append({
            "shape": [b, h, w, c], "max_abs_err": err, "bound_ms": fb,
            "bound_by": fby, "calls": 1,
            "ms": cuda_ms(lambda: pool_moments_fwd(y, s)),
            "plain_ms": cuda_ms(lambda: pool_moments_fwd_plain(y, s),
                                iters=3),
            "library_ms": None})
        rows["pool_moments_bwd"].append({
            "shape": [b, h, w, c], "max_abs_err": 0.0, "bound_ms": bb,
            "bound_by": bby, "calls": 1,
            "ms": cuda_ms(lambda: pool_moments_bwd(*args)),
            "plain_ms": cuda_ms(lambda: pool_moments_bwd_plain(*args),
                                iters=3),
            "library_ms": None})
        del y, got, args, gy
    return rows


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)


def _check_k5(name, got, ref, kinds, dtype) -> float:
    """Each output against the plain one, ``kinds`` per output: "out" (in
    the activation dtype), "f32" (an f32 output), "sum" (an f32 sum);
    returns the largest abs error. Relu masks: where the plain gradient
    is 0, so is the kernel's, and only there."""
    worst = 0.0
    for k, (u, v, kind) in enumerate(zip(got, ref, kinds)):
        if v is None:
            if u is not None:
                raise AssertionError(f"{name}: output {k} should be None")
            continue
        u, v = u.float(), v.float()
        err = (u - v).abs()
        scale = max(v.abs().max().item(), 1e-30)
        if kind == "sum":
            bound = STAT_SUM_TOL * scale
        elif kind == "f32" or dtype == torch.float32:
            bound = F32_TOL * scale
        else:
            bound = _bf16_ulp(v) + F32_TOL * scale
        if not bool((err <= bound).all()):
            raise AssertionError(
                f"{name} {dtype} output {k} ({kind}): max abs err "
                f"{err.max().item()} of scale {scale}")
        worst = max(worst, err.max().item())
    return worst


def _masks_agree(name, dyp, ref, yp, k, b) -> int:
    """The relu mask: the kernel's ``dyp`` is exactly 0 wherever the plain
    ``pre = k * yp + b`` is not > 0 (ties included), and inside the mask
    0 only where the plain ``ref`` is within F32_TOL of the scale of 0 (a
    gradient that cancels can land on an exact 0 in one summation order
    and not in the other). Returns the count of such zeros."""
    mask = fs._pre(yp, k, b).float() > 0
    if bool((dyp[~mask] != 0).any()):
        raise AssertionError(f"{name}: gradient where the relu is off")
    zero = mask & (dyp == 0)
    near = ref.float().abs() <= F32_TOL * ref.float().abs().max()
    if bool((zero & ~near).any()):
        raise AssertionError(f"{name}: no gradient inside the relu mask")
    return int(zero.sum())


def check_fused_train(dtype, gen) -> dict:
    """The decoder's training kernels at the step's shapes: the query pass
    (B = 1) and the ad pass (B = 32), 16 groups of 128 points a cloud,
    widths 3 -> 1539 -> 769 -> 384 -> 3. Inputs on a 0.25 grid with k = 1,
    b = -0.25 on a quarter of the channels force exact relu ties."""
    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    def affine(din):
        k = 0.5 + torch.rand((C, NN, din), generator=gen, device="cuda")
        b = rnd(C, NN, din, scale=0.3)
        k[..., ::4], b[..., ::4] = 1.0, -0.25
        return k, b

    def rows(r, din):
        return (rnd(C, NN, r, din, scale=2.0) * 4).round().div(4).to(dtype)

    f32 = torch.float32
    peak = dtype                             # GEMMs: the dtype's peak

    def row(shape, err, kern, plain, nb, ops, ops_dtype, library=None):
        bnd, by = bound_ms(nb, ops, ops_dtype)
        return {"shape": shape, "max_abs_err": err, "bound_ms": bnd,
                "bound_by": by, "calls": 1, "ms": cuda_ms(kern),
                "plain_ms": cuda_ms(plain, iters=3),
                "library_ms": cuda_ms(library) if library else None}

    out = {k: [] for k in K5_TRAIN}
    g = C * NN
    for b in DEC_BATCHES:
        r = b * PPN
        # layer 1 with statistics, and its backward
        d, wd = rnd(C, NN, r, 3, dt=dtype).tanh(), \
            rnd(C, NN, 3, D0, scale=0.3, dt=dtype)
        yc = rnd(C, NN, b, D0)
        sc = (yc - yc.mean(dim=2, keepdim=True)).contiguous()
        got = fs.fused_l1_kernel(d, wd, yc, PPN, sc)
        # y against the plain y; the sums against the plain sums of the
        # kernel's own y (a bf16 y one ulp off moves z by that ulp)
        ycr, scr = (t.repeat_interleave(PPN, dim=2) for t in (yc, sc))
        z = got[0].float() - ycr
        err = _check_k5("fused_l1_stats", got,
                        (fs.fused_l1_plain(d, wd, yc, PPN), z.sum(2),
                         (z * z).sum(2), (z * scr).sum(2)),
                        ("out", "sum", "sum", "sum"), dtype)
        del ycr, scr, z
        out["fused_l1_stats"].append(row(
            [C, NN, r, 3, D0], err,
            lambda: fs.fused_l1_kernel(d, wd, yc, PPN, sc),
            lambda: fs.fused_l1_plain(d, wd, yc, PPN, sc),
            nbytes(d, wd, yc, sc, *got), 11 * got[0].numel(), f32))
        y1 = got[0]
        gy1 = rnd(C, NN, r, D0, dt=dtype)
        gz = [rnd(C, NN, D0, scale=0.01) for _ in range(3)]
        args = (d, wd, yc, sc, y1, gy1, *gz, PPN)
        got = fs.fused_l1_bwd_kernel(*args)
        err = _check_k5("fused_l1_bwd", got, fs.fused_l1_bwd_plain(*args),
                        ("out", "out", "sum", "sum"), dtype)
        out["fused_l1_bwd"].append(row(
            [C, NN, r, 3, D0], err, lambda: fs.fused_l1_bwd_kernel(*args),
            lambda: fs.fused_l1_bwd_plain(*args),
            nbytes(d, wd, yc, sc, y1, gy1, *gz, *got),
            4 * 3 * gy1.numel() + 8 * gy1.numel(), f32))
        del y1, gy1, got, args
        # mid layers with statistics, dx and dW
        for din, dout in MID_SHAPES:
            yp, (k, bb) = rows(r, din), affine(din)
            w = rnd(C, NN, din, dout, scale=din ** -0.5, dt=dtype)
            sh = rnd(C, NN, dout, scale=0.1)
            got = fs.fused_mid_kernel(yp, k, bb, w, sh)
            z = got[0].float() - sh[:, :, None, :]
            err = _check_k5("fused_mid_stats", got,
                            (fs.fused_mid_plain(yp, k, bb, w), z.sum(2),
                             (z * z).sum(2)), ("out", "sum", "sum"), dtype)
            del z
            a3 = fs._affine_relu(yp, k, bb).reshape(g, r, din)
            w3 = w.reshape(g, din, dout)
            ops = 2 * g * r * din * dout
            out["fused_mid_stats"].append(row(
                [C, NN, r, din, dout], err,
                lambda: fs.fused_mid_kernel(yp, k, bb, w, sh),
                lambda: fs.fused_mid_plain(yp, k, bb, w, sh),
                nbytes(yp, k, bb, w, sh, *got), ops, peak,
                lambda: torch.bmm(a3, w3)))
            y = got[0]
            gy = rnd(C, NN, r, dout, dt=dtype)
            gzs, gzq = rnd(C, NN, dout, scale=0.01), rnd(C, NN, dout,
                                                         scale=0.01)
            args = (yp, k, bb, w, sh, y, gy, gzs, gzq)
            got = fs.fused_mid_dx_kernel(*args)
            ref = fs.fused_mid_dx_plain(*args)
            _masks_agree("fused_mid_dx", got[0], ref[0], yp, k, bb)
            err = _check_k5("fused_mid_dx", got, ref, ("out", "sum", "sum"),
                            dtype)
            g3 = gy.reshape(g, r, dout)
            out["fused_mid_dx"].append(row(
                [C, NN, r, din, dout], err,
                lambda: fs.fused_mid_dx_kernel(*args),
                lambda: fs.fused_mid_dx_plain(*args),
                nbytes(*args, *got), ops, peak,
                lambda: torch.bmm(g3, w3.transpose(1, 2))))
            dargs = (yp, k, bb, sh, y, gy, gzs, gzq, dtype)
            got = fs.fused_mid_dw_kernel(*dargs)
            err = _check_k5("fused_mid_dw", (got,),
                            (fs.fused_mid_dw_plain(*dargs),), ("out",),
                            dtype)
            out["fused_mid_dw"].append(row(
                [C, NN, r, din, dout], err,
                lambda: fs.fused_mid_dw_kernel(*dargs),
                lambda: fs.fused_mid_dw_plain(*dargs),
                nbytes(*dargs[:-1], got), ops, peak,
                lambda: torch.bmm(a3.transpose(1, 2), g3)))
            del yp, y, gy, got, ref, args, dargs, a3, g3
        # output layer's backward
        din = MID_SHAPES[-1][1]
        yp, (k, bb) = rows(r, din), affine(din)
        w = rnd(C, NN, din, 3, scale=din ** -0.5, dt=dtype)
        yo = fs.fused_out_kernel(yp, k, bb, w, rnd(C, NN, 3, scale=0.1))
        gyo = rnd(C, NN, r, 3)
        args = (yp, k, bb, w, yo, gyo)
        got = fs.fused_out_bwd_kernel(*args)
        ref = fs.fused_out_bwd_plain(*args)
        _masks_agree("fused_out_bwd", got[0], ref[0], yp, k, bb)
        err = _check_k5("fused_out_bwd", got, ref,
                        ("out", "sum", "sum", "out", "sum"), dtype)
        out["fused_out_bwd"].append(row(
            [C, NN, r, din, 3], err, lambda: fs.fused_out_bwd_kernel(*args),
            lambda: fs.fused_out_bwd_plain(*args), nbytes(*args, *got),
            4 * 3 * yp.numel() + 6 * yp.numel(), f32))
        del yp, yo, gyo, got, ref, args
        torch.cuda.empty_cache()
    return out


def _unit_clouds(b, n, gen):
    """(b, n, 3) gaussian clouds scaled into the unit ball, on the card."""
    p = torch.randn((b, n, 3), generator=gen, device="cuda")
    return p / p.norm(dim=-1).amax(dim=-1)[:, None, None]


def sinkhorn_bound(iters: torch.Tensor, n: int, m: int, clock_hz: float
                   ) -> tuple:
    """Least time of a solve: its exponentials (2 N M a cloud for each
    iteration the cloud ran, counted from the run) at the SMs' ex2 rate,
    or its bytes (points in, potentials out) at HBM rate."""
    b = iters.numel()
    t_ops = 2.0 * n * m * float(iters.sum()) / (
        MUFU_EX2_PER_CLOCK_SM * SMS * clock_hz) * 1e3
    t_bytes = 4.0 * b * (n + m) * 4 / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sinkhorn_case(name, x, y, kw, clock_hz, g0=None) -> dict:
    """K6 (K11 with ``g0``) against its plain version on the same inputs:
    potentials, values and per-cloud iteration counts; times by CUDA
    events."""
    kw = dict(kw, g0=g0)
    got = emd.sinkhorn_potentials(x, y, **kw)
    ref = emd.sinkhorn_potentials_plain(x, y, **kw)
    torch.cuda.synchronize()
    scale = max(ref[0].abs().max().item(), ref[1].abs().max().item())
    pot_err = max((got[k] - ref[k]).abs().max().item() for k in (0, 1))
    c = emd.pairwise_sqdist(x, y)
    vk = emd.transport_cost(c, got[0], got[1], kw["eps"])
    vp = emd.transport_cost(c, ref[0], ref[1], kw["eps"])
    del c
    val_err = (vk - vp).abs()
    iters_diff = int((got[2] - ref[2]).abs().max())
    row = {"case": name, "shape": [x.shape[0], x.shape[1], y.shape[1]],
           "iters": got[2].tolist(), "plain_iters": ref[2].tolist(),
           "max_abs_err": pot_err, "pot_scale": scale,
           "value_max_rel_err": (val_err / vp.abs()).max().item(),
           "value_max_abs_err": val_err.max().item()}
    if not (pot_err <= SINKHORN_POT_TOL * scale
            and bool((val_err <= SINKHORN_ATOL + SINKHORN_RTOL * vp.abs())
                     .all()) and iters_diff <= SINKHORN_ITERS_TOL):
        raise AssertionError(f"sinkhorn {name}: kernel vs plain out of "
                             f"bounds: {row}")
    row["bound_ms"], row["bound_by"] = sinkhorn_bound(
        got[2], x.shape[1], y.shape[1], clock_hz)
    row["ms"] = cuda_ms(lambda: emd.sinkhorn_potentials(x, y, **kw),
                        iters=3, repeats=3)
    row["plain_ms"] = cuda_ms(
        lambda: emd.sinkhorn_potentials_plain(x, y, **kw), iters=1,
        repeats=3)
    row["library_ms"] = None        # no PyTorch call computes potentials
    row["calls"] = 1
    return row


def check_sinkhorn(gen, clock_hz) -> dict:
    """K6 at the evaluator's shapes (B = 1 and a chunk of 16 clouds, 2048
    points, eps 2e-4, 360 iterations; the chunk mixes four easy pairs, y =
    x + noise of four sizes, with hard ones so that clouds exit at
    different iterations), at the emd training loss's (B = 1 and 32, eps
    0.01, 100 iterations) and at tol = 0 (80 iterations at eps 0.01); K11
    at B = 2 with the warm start of ``coarse = 256``. Then the multiscale
    path through ``sinkhorn_emd(coarse=256)``, counts reset just before
    and read just after."""
    rows = {"sinkhorn": [], "sinkhorn_warm": []}
    x, y = _unit_clouds(16, NPTS, gen), _unit_clouds(16, NPTS, gen)
    for i, noise in enumerate((0.003, 0.01, 0.03, 0.1)):
        y[i] = x[i] + noise * torch.randn((NPTS, 3), generator=gen,
                                          device="cuda")
    rows["sinkhorn"].append(sinkhorn_case("eval B=16", x, y, EVAL_DEFAULTS,
                                          clock_hz))
    if len(set(rows["sinkhorn"][-1]["iters"])) < 2:
        raise AssertionError("sinkhorn: the mixed batch's clouds all ran "
                             "the same iterations")
    rows["sinkhorn"].append(sinkhorn_case("eval B=1", x[4:5], y[4:5],
                                          EVAL_DEFAULTS, clock_hz))
    for b in (Q_TR, S_TR):
        xt, yt = _unit_clouds(b, NPTS, gen), _unit_clouds(b, NPTS, gen)
        rows["sinkhorn"].append(sinkhorn_case(f"train B={b}", xt, yt,
                                              TRAIN_EMD, clock_hz))
    rows["sinkhorn"].append(sinkhorn_case(
        "tol=0 B=4", x[:4], y[4:8], dict(TRAIN_EMD, n_iters=80, tol=0.0),
        clock_hz))
    xw, yw = _unit_clouds(2, NPTS, gen), _unit_clouds(2, NPTS, gen)
    g0 = emd.coarse_warm_start(xw, yw, 256, eps=0.01, n_iters=360,
                               anneal_frac=0.5, eps0=0.1,
                               tol=emd.DEFAULT_TOL, omega=emd.DEFAULT_OMEGA)
    rows["sinkhorn_warm"].append(sinkhorn_case(
        "warm B=2 coarse=256", xw, yw,
        dict(EVAL_DEFAULTS, eps0=0.01, anneal_frac=0.4), clock_hz, g0=g0))
    ops.reset_launch_counts()
    value = emd.sinkhorn_emd(xw, yw, coarse=256)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts["sinkhorn"] != 1 or counts["sinkhorn_warm"] != 1 \
            or not bool(torch.isfinite(value).all()):
        raise AssertionError(f"multiscale path: launches {counts}, value "
                             f"{value.tolist()}")
    return rows, {"counts": counts, "values": value.tolist()}


# -- phases 4 and 5: the serving path ----------------------------------------

def serving_inputs(gen):
    imgs = torch.randint(0, 256, (Q, IMG, IMG, 3), generator=gen,
                         dtype=torch.uint8).numpy()
    pcs = torch.randn((SUPPORT, NPTS, 3), generator=gen)
    pcs = (pcs / pcs.norm(dim=-1, keepdim=True).amax(dim=1, keepdim=True))
    return imgs, pcs.numpy()


def drive_main_path(server: Generator, imgs, pcs) -> tuple:
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    proto = server.prototype(pcs)
    torch.cuda.synchronize()
    proto_ms = (time.perf_counter() - t0) * 1e3
    call_ms, outs = [], []
    for i in range(CALLS):
        before = ops.launch_counts()
        t0 = time.perf_counter()
        outs.append(server(imgs, proto=proto))       # returns on the host
        call_ms.append((time.perf_counter() - t0) * 1e3)
        after = ops.launch_counts()
        for name, per_call in PER_CALL.items():
            if after[name] - before[name] != per_call:
                raise AssertionError(
                    f"request {i}: {name} launched "
                    f"{after[name] - before[name]} times, expected {per_call}")
    counts = ops.launch_counts()
    for out in outs:
        if out.shape != (Q, NPTS, 3) or not np.isfinite(out).all() \
                or np.abs(out).max() > 1.0:
            raise AssertionError(f"bad output {out.shape}, finite "
                                 f"{np.isfinite(out).all()}")
    return proto, {"counts": counts, "prototype_ms": proto_ms,
                   "call_ms": call_ms,
                   "out_absmax": float(np.abs(outs[0]).max())}


def compare_with_cpu(server: Generator, imgs, pcs, proto) -> dict:
    tp = server.model.pc_decoder.template_points(
        Q, torch.Generator().manual_seed(SEED + 1))
    xq = torch.from_numpy(imgs).float() * (2.0 / 255.0) - 1.0
    with torch.inference_mode():
        card = server.model.generate_from_proto(xq.cuda(), proto, tp).cpu()
        cpu_model = build_model(FPSGConfig(), torch.Generator()).eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   server.model.state_dict().items()})
        cpu_proto = cpu_model.encode_prototype(torch.from_numpy(pcs))
        cpu = cpu_model.generate_from_proto(xq, cpu_proto, tp)
    proto_err = (proto.cpu() - cpu_proto).abs().max().item()
    err = (card - cpu).abs().max().item()
    if not err <= PATH_TOL * cpu.abs().max().item():
        raise AssertionError(f"card vs CPU path: max abs diff {err} > "
                             f"{PATH_TOL} of the output scale")
    return {"max_abs_diff": err, "proto_max_abs_diff": proto_err,
            "out_absmax": cpu.abs().max().item()}


def check_stream(server: Generator, imgs, proto) -> float:
    batches = [imgs, imgs[::-1].copy(), imgs // 2]
    twin = Generator(server.model, seed=SEED + 7)
    per_call = [twin(b, proto=proto) for b in batches]
    streamed = list(Generator(server.model, seed=SEED + 7).stream(
        iter(batches), proto=proto))
    if len(streamed) != len(batches):
        raise AssertionError("stream yielded the wrong number of batches")
    diff = max(float(np.abs(s - p).max()) for s, p in zip(streamed, per_call))
    if diff > 1e-6:
        raise AssertionError(f"stream vs per-call: max abs diff {diff}")
    return diff


KERNEL_GROUPS = (                       # device-time buckets, by name
    ("sinkhorn (K6/K11)", ("half_iter_kernel",)),
    ("port kernels", ("maxpool2x2_kernel", "maxpool2x2_bwd_kernel",
                      "fused_l1_kernel", "mid_fwd_kernel", "mid_dx_kernel",
                      "mid_dw_kernel", "l1_bwd_kernel", "out_bwd_kernel",
                      "sum_parts_kernel", "fused_out_kernel",
                      "nn_both_kernel", "segment_sum_kernel",
                      "moments_fwd_kernel", "moments_sum_kernel",
                      "moments_bwd_kernel")),
    # cuDNN's direct, implicit-GEMM, Winograd and FFT convolutions, the
    # complex GEMMs and transforms of its FFT path, its layout transposes
    ("convolutions", ("fprop", "dgrad", "wgrad", "conv", "winograd",
                      "cudnn", "fft", "DSE", "complex", "cf32",
                      "region_transform")),
    ("matmuls", ("gemm", "cutlass", "cublas")),
    ("reductions", ("reduce_kernel", "Welford")),
    ("copies", ("memcpy", "Memcpy", "copy")),
)


def profile(fn, name: str) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device time by kernel
    and by group, and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}      # device-side events only: kernels and copies (CPU
    for ev in prof.key_averages():    # ops and annotated ranges would
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and not ev.is_user_annotation \
                and ev.self_device_time_total > 0:    # count twice)
            by_name[ev.key] = by_name.get(ev.key, 0.0) \
                + ev.self_device_time_total / 1e3
    (OUT_DIR / f"chip_smoke_profile{name}.txt").write_text(
        "\n".join(f"{ms:10.4f} ms  {key}" for key, ms in
                  sorted(by_name.items(), key=lambda kv: -kv[1])))
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other (elementwise)"] = 0.0
    for key, ms in by_name.items():
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in key for k in keys)), "other (elementwise)")
        groups[group] += ms
    busy = sum(by_name.values())
    return {"wall_ms": wall_ms,
            "device_ms": busy if busy > 0 else "not measured",
            "busy_share": busy / wall_ms if busy > 0 else "not measured",
            "groups_ms": groups,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


# -- phases 7 to 9: the training step ---------------------------------------

def drive_training(per_step: dict, fused=None, **conf_kw) -> tuple:
    """The training path at the flagship width: 1 warm and TRAIN_STEPS
    timed calls of the step (each ``steps_per_call`` optimizer steps),
    launch counts checked per optimizer step against ``per_step``.
    ``fused`` sets the model's ``decoder_fused`` (None: the default)."""
    conf = FPSGConfig(seed=SEED, n_shot=S_TR, n_query=Q_TR,
                      intra_recon=True, **conf_kw)
    k_steps = max(conf.steps_per_call, 1)
    t0 = time.perf_counter()
    corpus = synthetic_device_corpus(2, 48, NPTS, IMG, seed=SEED)
    state = init_state(conf)
    if fused is not None:
        state.model.pc_decoder.fused = fused
    step = make_train_step(conf)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_ms, host_ms, metrics = [], [], []
    for i in range(1 + TRAIN_STEPS):
        before = ops.launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, corpus, gen)
        host_ms.append((time.perf_counter() - t0) * 1e3)   # enqueued
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = ops.launch_counts()
        for name, want in per_step.items():
            if after[name] - before[name] != want * k_steps:
                raise AssertionError(
                    f"train call {i} ({conf_kw}): {name} launched "
                    f"{after[name] - before[name]} times, expected "
                    f"{want} x {k_steps}")
        metrics.append({k: v.tolist() for k, v in m.items()})
    counts = ops.launch_counts()
    for m in metrics:
        if not all(np.isfinite(m[k]).all() for k in ("query_rec_loss",
                                                     "support_rec_loss")):
            raise AssertionError(f"non-finite training loss: {m}")
    median_ms = statistics.median(step_ms[1:]) / k_steps
    return state, corpus, step, gen, {
        "init_s": init_s, "steps_per_call": k_steps,
        "warm_step_ms": step_ms[0], "step_ms": step_ms[1:],
        "median_step_ms": median_ms, "episodes_per_s": 1e3 / median_ms,
        "median_host_ms": statistics.median(host_ms[1:]) / k_steps,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "counts": counts, "metrics": metrics}


GRAD_SAMPLE = ("img_encoder.encoder.features_0.weight",
               "img_encoder.encoder.features_40.weight",
               "pc_encoder.pointnet_feat_extractor.conv1.weight",
               "pc_encoder.pointnet_feat_extractor.stn.fc3.weight",
               "pc_decoder.deformer_conv1.weight",
               "pc_decoder.node_conv1.weight",
               "pc_decoder.node_conv4.weight")


N_S_RED, NPTS_RED, IMG_RED = 8, 512, 64       # the reduced step's size


def reduced_step(device, noise: float = 0.0, fused=None,
                 **conf_kw) -> tuple:
    """One step (loss, backward, running-statistics update) at the reduced
    size on ``device``, from the weights of ``SEED`` (times 1 + ``noise`` x
    a fixed normal draw), a fixed episode and fixed template points:
    (losses, the GRAD_SAMPLE gradients, the state dict), on the CPU.
    ``fused`` sets the decoder's ``decoder_fused`` (None: the default)."""
    conf = FPSGConfig(seed=SEED, n_shot=N_S_RED, n_query=Q_TR,
                      num_pts=NPTS_RED, intra_recon=True, **conf_kw)
    corpus = synthetic_device_corpus(2, 12, NPTS_RED, IMG_RED, seed=SEED,
                                     device="cpu")
    batch = sample_episode(corpus, N_S_RED, Q_TR,
                           torch.Generator().manual_seed(SEED))
    model = init_model(conf, "cpu")
    if noise:
        g = torch.Generator().manual_seed(SEED + 5)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + noise * torch.randn(p.shape, generator=g))
    model = model.to(device)
    dec = model.pc_decoder
    if fused is not None:
        dec.fused = fused
    tp = {"query": dec.template_points(
              Q_TR, torch.Generator().manual_seed(SEED + 3)),
          "support": dec.template_points(
              N_S_RED, torch.Generator().manual_seed(SEED + 4))}
    loss = model.loss({k: v.to(device) for k, v in batch.items()},
                      {k: v.to(device) for k, v in tp.items()})
    loss["ttl_loss"].backward()
    grads = {n: p.grad.detach().cpu() for n, p in
             model.named_parameters() if n in GRAD_SAMPLE}
    return ({k: v.item() for k, v in loss.items()}, grads,
            {k: v.detach().cpu() for k, v in model.state_dict().items()})


def compare_training_with_cpu() -> dict:
    """One precise_stats f32 step at the reduced size on the card and on
    the CPU, from the same weights, episode and template points."""
    out = {d: reduced_step(d, precise_stats=True) for d in ("cuda", "cpu")}
    (lc, gc, sc), (lh, gh, sh) = out["cuda"], out["cpu"]
    res = {"loss_rel_diff": {k: abs(lc[k] - lh[k]) / abs(lh[k])
                             for k in ("query_rec_loss",
                                       "support_rec_loss")},
           "grad_rel_diff": {}, "losses_cpu": lh}
    for n in GRAD_SAMPLE:
        res["grad_rel_diff"][n] = rel_err(gc[n], gh[n])[1]
    # running statistics only: Adam's first step moves each parameter by
    # ~lr * sign(gradient), which turns gradient noise near 0 into
    # differences of 2 lr; the gradient sample covers the parameters
    state = {k: rel_err(sc[k], sh[k])[1] for k in sh if "running_" in k}
    worst = max(state, key=state.get)
    res["state_worst"] = [worst, state[worst]]
    bad = [k for k, v in res["loss_rel_diff"].items() if not v <= TRAIN_LOSS_TOL]
    bad += [k for k, v in res["grad_rel_diff"].items()
            if not v <= TRAIN_GRAD_TOL]
    bad += [k for k, v in state.items() if not v <= TRAIN_STATE_TOL]
    if bad:
        raise AssertionError(f"training step, card vs CPU, out of bounds: "
                             f"{bad[:8]} ({res})")
    return res


def _distances(a: tuple, b: tuple) -> dict:
    """Per quantity: losses (relative), the gradient sample (relative
    Frobenius norm), running statistics (max abs) of step ``a`` from
    step ``b``."""
    (la, ga, sa), (lb, gb, sb) = a, b
    out = {f"loss {k}": abs(la[k] - lb[k]) / abs(lb[k])
           for k in ("query_rec_loss", "support_rec_loss")}
    out.update({f"grad {n}": float((ga[n] - gb[n]).norm() / gb[n].norm())
                for n in GRAD_SAMPLE})
    out.update({f"stat {k}": float((sa[k] - sb[k]).abs().max())
                for k in sb if "running_" in k})
    return out


def compare_single_read_with_cpu(cpu_fused="off", card_fused="off",
                                 **conf_kw) -> dict:
    """The reduced step with single-read statistics: f32 card vs CPU within
    the TRAIN_*_TOL bounds; bf16 card vs CPU within SR_FACTOR x the CPU
    path's own bf16 rounding sensitivity. The decoder's node chain as
    ``cpu_fused`` / ``card_fused`` (bench.py's: "on" / None, the card's
    default); ``conf_kw`` goes to the configuration (``pc_dist``)."""
    cpu32 = reduced_step("cpu", fused=cpu_fused, **conf_kw)
    cpu16 = reduced_step("cpu", fused=cpu_fused, compute_dtype="bf16",
                         **conf_kw)
    cpu16n = reduced_step("cpu", noise=1e-7, fused=cpu_fused,
                          compute_dtype="bf16", **conf_kw)
    card32 = reduced_step("cuda", fused=card_fused, **conf_kw)
    card16 = reduced_step("cuda", fused=card_fused, compute_dtype="bf16",
                          **conf_kw)
    gap, wiggle = _distances(cpu16, cpu32), _distances(cpu16n, cpu16)
    dist = _distances(card16, cpu16)
    ratio = {k: dist[k] / max(gap[k], wiggle[k], 1e-30) for k in dist}
    f32 = _distances(card32, cpu32)
    f32_bad = [k for k, v in f32.items() if not v <= (
        TRAIN_LOSS_TOL if k.startswith("loss") else
        TRAIN_GRAD_TOL if k.startswith("grad") else
        TRAIN_STATE_TOL * max(float(cpu32[2][k[5:]].abs().max()), 1e-30))]
    worst = max(ratio, key=ratio.get)
    res = {"f32_worst": max(f32.items(), key=lambda kv: kv[1]),
           "bf16_worst_ratio": [worst, ratio[worst]],
           "bf16_loss_rel_diff": {k: v for k, v in dist.items()
                                  if k.startswith("loss")},
           "bf16_loss_gap": {k: v for k, v in gap.items()
                             if k.startswith("loss")},
           "losses_cpu_bf16": cpu16[0]}
    bad = [k for k, v in ratio.items() if not v <= SR_FACTOR]
    if f32_bad or bad:
        raise AssertionError(f"single-read step, card vs CPU, out of bounds: "
                             f"f32 {f32_bad[:8]}, bf16 {bad[:8]} ({res})")
    return res


# -- phases 16 to 18: the evaluator -----------------------------------------

def drive_eval() -> tuple:
    """The evaluator at the flagship width (benchmarks/eval_bench.py:34-45:
    1-way 32-shot, Q = 1, ``intra_support``, bf16, random weights from
    SEED) on a synthetic corpus of 2 classes x 48 items made on the card:
    1 warm and EVAL_CALLS timed calls of ``episodic_eval`` (EVAL_EPISODES
    episodes in chunks of EVAL_CHUNK) with EMD and without, launch counts
    checked per chunk; the per-class lines of ``evaluate``; SEQ_ITEMS items
    of ``run_sequential``. The running statistics must not move."""
    conf = FPSGConfig(seed=SEED, n_shot=S_TR, n_query=Q_TR, intra_recon=True,
                      compute_dtype="bf16", eval_episodes=EVAL_EPISODES,
                      eval_chunk=EVAL_CHUNK)
    t0 = time.perf_counter()
    corpus = synthetic_device_corpus(2, 48, NPTS, IMG, seed=SEED)
    model = ImgPCProtoNet.from_config(conf)
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0}
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if "running_" in k}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    n_chunks = EVAL_EPISODES // EVAL_CHUNK
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for with_emd, per_chunk in ((True, PER_CHUNK_EVAL),
                                (False, PER_CHUNK_EVAL_NO_EMD)):
        step = make_eval_step(model, S_TR, Q_TR, with_emd=with_emd)
        call_ms, outs = [], []
        for i in range(1 + EVAL_CALLS):
            before = ops.launch_counts()
            t0 = time.perf_counter()
            out = episodic_eval(step, corpus, gen, EVAL_EPISODES, EVAL_CHUNK)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t0) * 1e3)
            after = ops.launch_counts()
            for name, want in per_chunk.items():
                if after[name] - before[name] != want * n_chunks:
                    raise AssertionError(
                        f"eval call {i} (emd {with_emd}): {name} launched "
                        f"{after[name] - before[name]} times, expected "
                        f"{want} x {n_chunks}")
            outs.append({k: v.float().cpu() for k, v in out.items()})
        for out in outs:
            for k, v in out.items():
                if v.shape != (EVAL_EPISODES,) or not bool(
                        torch.isfinite(v).all()):
                    raise AssertionError(f"eval {k}: {v}")
        med = statistics.median(call_ms[1:])
        res["emd" if with_emd else "no_emd"] = {
            "warm_call_ms": call_ms[0], "call_ms": call_ms[1:],
            "episodes_per_s": EVAL_EPISODES * 1e3 / med,
            "means": {k: float(v.mean()) for k, v in outs[-1].items()
                      if k != "cls"}}
    res["per_class"] = evaluate(model, corpus, conf, gen)
    t0 = time.perf_counter()
    seq = [(c, i, out) for c, i, out in itertools.islice(
        run_sequential(model, corpus, conf, gen), SEQ_ITEMS)]
    res["sequential"] = {
        "items": len(seq), "ms": (time.perf_counter() - t0) * 1e3,
        "first": seq[0], "cd_mean": statistics.mean(o["cd"] for *_, o in seq),
        "emd_mean": statistics.mean(o["emd"] for *_, o in seq)}
    if len(seq) != SEQ_ITEMS or not all(
            np.isfinite([o["cd"], o["emd"]]).all() for *_, o in seq):
        raise AssertionError(f"sequential eval: {res['sequential']}")
    res["counts"] = ops.launch_counts()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    moved = [k for k, v in stats0.items()
             if not torch.equal(model.state_dict()[k], v)]
    if moved:
        raise AssertionError(f"evaluation moved running statistics: "
                             f"{moved[:4]}")
    steps = {w: make_eval_step(model, S_TR, Q_TR, with_emd=w)
             for w in (True, False)}
    return steps, corpus, gen, res


def compare_eval_with_cpu() -> dict:
    """``reconstruct`` of 2 episodes at the reduced size (8 support, 64x64
    images, 512 points, the full-width decoder, f32), called in training
    mode, on the card and on the CPU from the same weights (running
    statistics drawn from a seed), episodes and template points: CD and
    the clouds within PATH_TOL, EMD within the K6 bound."""
    conf = FPSGConfig(seed=SEED, n_shot=N_S_RED, n_query=Q_TR,
                      num_pts=NPTS_RED, intra_recon=True)
    corpus = synthetic_device_corpus(2, 12, NPTS_RED, IMG_RED, seed=SEED,
                                     device="cpu")
    batch = sample_episode_batch(corpus, N_S_RED, Q_TR, 2,
                                 torch.Generator().manual_seed(SEED))
    model = init_model(conf, "cpu")
    g = torch.Generator().manual_seed(SEED + 6)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    tp = model.pc_decoder.template_points(
        2 * Q_TR, torch.Generator().manual_seed(SEED + 3))
    out = {}
    for dev in ("cpu", "cuda"):
        twin = init_model(conf, "cpu")
        twin.load_state_dict(model.state_dict())
        twin = twin.to(dev)
        with torch.no_grad():
            r = twin.reconstruct({k: v.to(dev) for k, v in batch.items()},
                                 template_points=tp.to(dev))
        out[dev] = {k: v.float().cpu() for k, v in r.items()}
    card, cpu = out["cuda"], out["cpu"]
    res = {"cd_rel_diff": ((card["cd_loss"] - cpu["cd_loss"]).abs()
                           / cpu["cd_loss"].abs()).max().item(),
           "emd_abs_diff": (card["emd_loss"] - cpu["emd_loss"]).abs()
           .max().item(),
           "emd_cpu": cpu["emd_loss"].tolist(),
           "cd_cpu": cpu["cd_loss"].tolist(),
           "syn_max_abs_diff": rel_err(card["syn_pc"], cpu["syn_pc"])[0],
           "syn_scale": cpu["syn_pc"].abs().max().item()}
    emd_ok = bool(((card["emd_loss"] - cpu["emd_loss"]).abs()
                   <= SINKHORN_ATOL + SINKHORN_RTOL * cpu["emd_loss"].abs())
                  .all())
    if not (res["cd_rel_diff"] <= PATH_TOL and emd_ok
            and res["syn_max_abs_diff"] <= PATH_TOL * res["syn_scale"]):
        raise AssertionError(f"reconstruct, card vs CPU, out of bounds: "
                             f"{res}")
    return res


def kernel_line(name: str, rows: list, launches: int) -> dict:
    """One kernel's entry of the ``kernels`` line: times summed over the
    kernel's calls in one request or one step."""
    def total(key):
        return sum(r[key] * r.get("calls", 1) for r in rows)

    source, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": (total("library_ms")
                       if rows[0]["library_ms"] is not None else None),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    OUT_DIR.mkdir(exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    say("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count(),
        max_sm_clock_mhz=sm_mhz)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    report = _build.build()
    build_s = time.perf_counter() - t0
    (OUT_DIR / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k} ({v['seconds']:.1f} s)\n{v['log']}"
                  for k, v in report.items()))
    say("build", seconds=build_s,
        per_source={k: v["seconds"] for k, v in report.items()})

    gen = torch.Generator().manual_seed(SEED)
    gpu_gen = torch.Generator(device="cuda").manual_seed(SEED)
    detail = {"device": smi, "kernels": {}, "train_kernels": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        rows = {"maxpool2x2": check_pool(dtype, gen), **check_fused(dtype, gen)}
        detail["kernels"][name] = rows
        train_rows = {
            "maxpool2x2": check_pool(dtype, gpu_gen, TRAIN_POOL_SHAPES),
            "maxpool2x2_bwd": check_pool_bwd(dtype, gpu_gen),
            **check_moments(dtype, gpu_gen),
            **check_pool_moments(dtype, gpu_gen)}
        train_rows.update(check_fused_train(dtype, gpu_gen))
        if dtype == torch.float32:
            train_rows.update(check_chamfer(gpu_gen))
        detail["train_kernels"][name] = train_rows
        for kernel, per_shape in [*rows.items(), *train_rows.items()]:
            for row in per_shape:
                say(f"kernel {kernel} {name}", **row)
        torch.cuda.empty_cache()
    sinkhorn_rows, multiscale = check_sinkhorn(gpu_gen, sm_mhz * 1e6)
    detail["sinkhorn"] = sinkhorn_rows
    for kernel, per_shape in sinkhorn_rows.items():
        for row in per_shape:
            say(f"kernel {kernel} f32", **row)
    say("multiscale path", **multiscale)
    torch.cuda.empty_cache()

    conf = FPSGConfig(seed=SEED)
    t0 = time.perf_counter()
    server = Generator.from_config(conf)
    init_s = time.perf_counter() - t0
    imgs, pcs = serving_inputs(gen)
    proto, main_run = drive_main_path(server, imgs, pcs)
    say("serve", init_s=init_s, prototype_ms=main_run["prototype_ms"],
        call_ms=main_run["call_ms"], launches=main_run["counts"],
        out_absmax=main_run["out_absmax"])

    profiled = profile(lambda: server(imgs, proto=proto), "")
    say("profile", **profiled)

    plain = compare_with_cpu(server, imgs, pcs, proto)
    plain["stream_max_abs_diff"] = check_stream(server, imgs, proto)
    bf16_server = Generator.from_config(FPSGConfig(seed=SEED,
                                                   compute_dtype="bf16"))
    bf16_out = bf16_server(imgs, pcs)
    if not (np.isfinite(bf16_out).all() and np.abs(bf16_out).max() <= 1.0
            and bf16_out.shape == (Q, NPTS, 3)):
        raise AssertionError("bf16 request: non-finite or out of range")
    plain["bf16_out_absmax"] = float(np.abs(bf16_out).max())
    say("plain", **plain)
    del server, bf16_server, proto
    torch.cuda.empty_cache()

    state, corpus, step, tgen, train_run = drive_training(
        PER_STEP, precise_stats=True)
    say("train", **train_run)
    train_prof = profile(lambda: step(state, corpus, tgen), "_train")
    say("train profile", **train_prof)
    del state, corpus, step
    torch.cuda.empty_cache()
    train_plain = compare_training_with_cpu()
    say("train plain", **train_plain)
    torch.cuda.empty_cache()

    state, corpus, step, tgen, sr_run = drive_training(
        PER_STEP_SR, fused="off", precise_stats=False, compute_dtype="bf16")
    say("train single-read", **sr_run)
    sr_prof = profile(lambda: step(state, corpus, tgen), "_train_sr")
    say("single-read profile", **sr_prof)
    del state, corpus, step
    torch.cuda.empty_cache()
    sr_plain = compare_single_read_with_cpu()
    say("single-read plain", **sr_plain)
    torch.cuda.empty_cache()

    state, corpus, step, tgen, bench_run = drive_training(
        PER_STEP_BENCH, precise_stats=False, compute_dtype="bf16",
        bf16_moments=True, steps_per_call=BENCH_K)
    say("train bench", **bench_run)
    bench_prof = profile(lambda: step(state, corpus, tgen), "_train_bench")
    say("bench profile", **bench_prof)
    del state, corpus, step
    torch.cuda.empty_cache()
    bench_plain = compare_single_read_with_cpu(cpu_fused="on",
                                               card_fused=None)
    say("bench plain", **bench_plain)
    torch.cuda.empty_cache()

    eval_steps, corpus, egen, eval_run = drive_eval()
    say("eval", **eval_run)
    eval_prof = profile(lambda: eval_steps[True](corpus, egen, EVAL_CHUNK),
                        "_eval")
    k6_ms = eval_prof["groups_ms"]["sinkhorn (K6/K11)"]
    eval_prof["emd_share_of_call"] = k6_ms / eval_prof["wall_ms"]
    if isinstance(eval_prof["device_ms"], float):
        eval_prof["emd_share_of_device"] = k6_ms / eval_prof["device_ms"]
    say("eval profile", **eval_prof)
    eval_prof_no_emd = profile(
        lambda: eval_steps[False](corpus, egen, EVAL_CHUNK), "_eval_no_emd")
    say("eval profile without EMD", **eval_prof_no_emd)
    del eval_steps, corpus
    torch.cuda.empty_cache()
    eval_plain = compare_eval_with_cpu()
    say("eval plain", **eval_plain)
    torch.cuda.empty_cache()

    state, corpus, step, tgen, emd_run = drive_training(
        PER_STEP_EMD, precise_stats=False, compute_dtype="bf16",
        bf16_moments=True, steps_per_call=BENCH_K, pc_dist="emd")
    say("train emd", **emd_run)
    emd_prof = profile(lambda: step(state, corpus, tgen), "_train_emd")
    say("emd profile", **emd_prof)
    del state, corpus, step
    torch.cuda.empty_cache()
    emd_plain = compare_single_read_with_cpu(cpu_fused="on",
                                             card_fused=None, pc_dist="emd")
    say("emd plain", **emd_plain)

    # serving kernels at the serving shapes with the serving run's launches;
    # the training paths' kernels at the step's shapes with their runs'
    # launches (the single-read kernels in bf16, the main path's dtype)
    lines = []
    for kernel in SOURCES:
        if kernel == "sinkhorn":                 # per eval chunk of 16
            rows = [r for r in sinkhorn_rows[kernel]
                    if r["case"] == "eval B=16"]
            launches = eval_run["counts"][kernel]
        elif kernel == "sinkhorn_warm":          # the multiscale path
            rows = sinkhorn_rows[kernel]
            launches = multiscale["counts"][kernel]
        elif kernel in K5_TRAIN:
            rows = detail["train_kernels"]["bf16"][kernel]
            launches = bench_run["counts"][kernel]
        elif kernel in TRAIN_KERNELS:
            rows = detail["train_kernels"]["f32"][kernel]
            launches = train_run["counts"][kernel]
        elif kernel in SR_KERNELS:
            dt = "bf16" if kernel in STAT_KERNELS else "f32"
            rows = detail["train_kernels"][dt][kernel]
            launches = sr_run["counts"][kernel]
        else:
            rows = detail["kernels"]["f32"][kernel]
            launches = main_run["counts"][kernel]
        if launches < 1:
            raise AssertionError(f"{kernel}: not launched on its path")
        lines.append(kernel_line(kernel, rows, launches))
    detail.update(serve=main_run, profile=profiled, plain=plain,
                  build_s=build_s, init_s=init_s, train=train_run,
                  train_profile=train_prof, train_plain=train_plain,
                  train_single_read=sr_run, single_read_profile=sr_prof,
                  single_read_plain=sr_plain, train_bench=bench_run,
                  bench_profile=bench_prof, bench_plain=bench_plain,
                  multiscale=multiscale, eval=eval_run,
                  eval_profile=eval_prof,
                  eval_profile_no_emd=eval_prof_no_emd, eval_plain=eval_plain,
                  train_emd=emd_run, emd_profile=emd_prof,
                  emd_plain=emd_plain, kernels_line=lines)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
