"""fpsg_torch — the PyTorch/CUDA port of fpsg_tpu for NVIDIA Hopper.

A second package beside ``fpsg_tpu`` (the JAX reference, which it never
imports). The port goes one slice at a time; this package holds the
serving path:

- ``fpsg_torch.serve``   — ``Generator``: prototype, per-call, keyed and
                           streamed generation.
- ``fpsg_torch.models``  — ``ImgPCProtoNet`` (eval-mode entry points).
- ``fpsg_torch.nn``      — VGG16-bn, PointNet, the primitive decoder, the
                           eval-mode BatchNorm and the fused node-chain
                           layers (``nn/fused_stack.py``).
- ``fpsg_torch.ops``     — the 2x2 max-pool and the kernel build.
- ``fpsg_torch.csrc``    — CUDA C++ kernels for ``sm_90a``, built by
                           ``nvcc`` at first use (``ops/_build.py``).
- ``fpsg_torch.io``      — the bridge from JAX variables to a state dict.

Every kernel wrapper dispatches on its tensor's device: a CPU tensor runs
the plain PyTorch version, a CUDA tensor launches the kernel (or raises).
"""

__version__ = "0.1.0"
