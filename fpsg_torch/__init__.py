"""fpsg_torch — the PyTorch/CUDA port of fpsg_tpu for NVIDIA Hopper.

A second package beside ``fpsg_tpu`` (the JAX reference, which it never
imports). The port goes one slice at a time; this package holds the
serving path, the episodic training step (BatchNorm statistics
single-read or two-pass, f32 or bf16 compute, Chamfer or EMD loss) and
the evaluator:

- ``fpsg_torch.serve``   — ``Generator``: prototype, per-call, keyed and
                           streamed generation.
- ``fpsg_torch.train``   — ``init_state``, ``make_train_step``: one
                           episode, loss, backward and Adam per step;
                           ``evaluate``, ``make_eval_step``: per-class
                           CD and EMD of reconstructions.
- ``fpsg_torch.models``  — ``ImgPCProtoNet``: the training loss and the
                           eval-mode entry points.
- ``fpsg_torch.nn``      — VGG16-bn, PointNet, the primitive decoder, the
                           BatchNorm (batch statistics in training) and
                           the fused node-chain layers
                           (``nn/fused_stack.py``).
- ``fpsg_torch.ops``     — the 2x2 max-pool and its backward, the Chamfer
                           distance (nearest neighbour, segment sum), the
                           one-read BatchNorm moments of the PointNet and
                           VGG BN -> pool sites, the Sinkhorn EMD, and the
                           kernel build.
- ``fpsg_torch.data``    — the device corpus, the episode sampler and the
                           synthetic corpus.
- ``fpsg_torch.csrc``    — CUDA C++ kernels for ``sm_90a``, built by
                           ``nvcc`` at first use (``ops/_build.py``).
- ``fpsg_torch.io``      — the bridge from JAX variables to a state dict.

Every kernel wrapper dispatches on its tensor's device: a CPU tensor runs
the plain PyTorch version, a CUDA tensor launches the kernel (or raises).
"""

__version__ = "0.1.0"
