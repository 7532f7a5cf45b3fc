#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. build: every kernel of ``fpsg_torch/csrc`` built by ``nvcc`` (sm_90a).
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving shapes (Q = 8 images of 224x224; decoder C = Nn = 4,
   R = 8 x 128 rows), f32 and bf16 — the max-pool bitwise (values and
   first-match codes, with forced ties), the decoder layers within
   ``F32_TOL`` / ``BF16_TOL`` of the output scale. Times by CUDA events
   (median of repeats) for the kernel, the plain version and, where one
   PyTorch call computes the same function, that call (``F.max_pool2d``;
   ``torch.bmm`` on the already activated input for the mid layer).
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
7. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``, the profile's per-kernel
device times to ``chiprun_out/chip_smoke_profile.txt`` and the compiler's
``-Xptxas -v`` report to ``chiprun_out/chip_smoke_build.log``.
"""

from __future__ import annotations

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
from fpsg_torch.models import build_model
from fpsg_torch.nn import fused_stack as fs
from fpsg_torch.ops import _build
from fpsg_torch.ops.pool import maxpool2x2, maxpool2x2_plain
from fpsg_torch.serve import Generator

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
SEED = 0
Q, IMG, SUPPORT, NPTS, CALLS = 8, 224, 32, 2048, 5
POOL_SHAPES = [(Q, 224, 224, 64), (Q, 112, 112, 128), (Q, 56, 56, 256),
               (Q, 28, 28, 512), (Q, 14, 14, 512)]
C, NN, D0 = 4, 4, 1539                     # clusters, nodes, d_node
R = Q * (NPTS // C // NN)                  # rows per (cluster, node)
MID_SHAPES = [(D0, D0 // 2), (D0 // 2, D0 // 4)]   # 1539->769, 769->384
PER_CALL = {"maxpool2x2": 5, "fused_l1": 1, "fused_mid": 2, "fused_out": 1}
# Tolerances, as max |kernel - plain| / max |plain|: f32 products summed in
# another order; bf16 outputs round once to bf16 (2^-8 relative), and a
# different summation order can move a value to the neighbouring bf16.
F32_TOL, BF16_TOL = 1e-5, 1e-2
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
}


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

def check_pool(dtype, gen) -> list:
    rows = []
    for shape in POOL_SHAPES:
        # quantized values: many windows hold ties for the maximum
        x = (torch.randn(shape, generator=gen) * 4).round().div(4)
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
    ("port kernels", ("maxpool2x2_kernel", "fused_l1_kernel",
                      "fused_mid_kernel", "fused_out_kernel")),
    ("convolutions", ("conv", "xmma", "implicit", "winograd", "cudnn",
                      "fft", "DSE")),
    ("matmuls", ("gemm", "cutlass", "sgemm")),
    ("copies", ("memcpy", "Memcpy")),
)


def profile_request(server: Generator, imgs, proto) -> dict:
    """One request under ``torch.profiler``: device time by kernel and by
    group, and the device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    server(imgs, proto=proto)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server(imgs, proto=proto)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}                      # device-side events only: kernels,
    for ev in prof.key_averages():    # copies (CPU ops would count twice)
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) \
                + ev.self_device_time_total / 1e3
    (OUT_DIR / "chip_smoke_profile.txt").write_text(
        "\n".join(f"{ms:10.4f} ms  {name}" for name, ms in
                  sorted(by_name.items(), key=lambda kv: -kv[1])))
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, ms in by_name.items():
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] += ms
    busy = sum(by_name.values())
    return {"wall_ms": wall_ms,
            "device_ms": busy if busy > 0 else "not measured",
            "busy_share": busy / wall_ms if busy > 0 else "not measured",
            "groups_ms": groups,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}


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
    kind = torch.cuda.get_device_name(0)
    say("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
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
    detail = {"device": smi, "kernels": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        rows = {"maxpool2x2": check_pool(dtype, gen), **check_fused(dtype, gen)}
        detail["kernels"][name] = rows
        for kernel, per_shape in rows.items():
            for row in per_shape:
                say(f"kernel {kernel} {name}", **row)

    conf = FPSGConfig(seed=SEED)
    t0 = time.perf_counter()
    server = Generator.from_config(conf)
    init_s = time.perf_counter() - t0
    imgs, pcs = serving_inputs(gen)
    proto, main_run = drive_main_path(server, imgs, pcs)
    say("serve", init_s=init_s, prototype_ms=main_run["prototype_ms"],
        call_ms=main_run["call_ms"], launches=main_run["counts"],
        out_absmax=main_run["out_absmax"])

    profiled = profile_request(server, imgs, proto)
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

    lines = []
    f32 = detail["kernels"]["f32"]
    for kernel, (source, replaces) in SOURCES.items():
        rows = f32[kernel]
        # times summed over the kernel's call sites in one request
        lines.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_run["counts"][kernel],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{key: sum(r[key] for r in rows)
               for key in ("ms", "plain_ms", "bound_ms")},
            "bound_by": rows[0]["bound_by"],
            "library_ms": (sum(r["library_ms"] for r in rows)
                           if rows[0]["library_ms"] is not None else None),
        })
    detail.update(serve=main_run, profile=profiled, plain=plain,
                  build_s=build_s, init_s=init_s, kernels_line=lines)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
