"""Import hygiene and device rules of the PyTorch port (``fpsg_torch``).

- No module of the port imports JAX, flax or the JAX package (it keeps
  its own copies of what it needs).
- Importing the port, its serving module and ``chip_smoke`` loads no
  ``jax*``/``flax*``/``fpsg_tpu*`` module (checked in a fresh process).
- The entry points (serving, training, the device corpus) default to
  CUDA and raise without a card instead of running on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fpsg_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in [*(ROOT / "fpsg_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_jax_imports(path):
    bad = [m for m in _imports(ROOT / path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, fpsg_torch, fpsg_torch.serve, fpsg_torch.nn, "
        "fpsg_torch.models, fpsg_torch.io.bridge, fpsg_torch.train, "
        "fpsg_torch.data.synthetic, fpsg_torch.ops.chamfer, "
        "fpsg_torch.ops.moments, fpsg_torch.ops.pool_moments, "
        "fpsg_torch.ops.emd, fpsg_torch.train.eval\n"
        "assert 'fpsg_torch.ops._build' not in sys.modules, 'kernel build'\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_raise_without_a_card():
    from fpsg_torch.config import FPSGConfig
    from fpsg_torch.data.synthetic import synthetic_device_corpus
    from fpsg_torch.models import ImgPCProtoNet
    from fpsg_torch.serve import Generator
    from fpsg_torch.train import init_state

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    conf = FPSGConfig(num_clusters=1, num_nodes=1, num_pts=8,
                      bottleneck_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Generator.from_config(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImgPCProtoNet.from_config(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Generator.from_variables(conf, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(FPSGConfig(num_clusters=1, num_nodes=1, num_pts=8,
                              bottleneck_size=8, precise_stats=True))
    with pytest.raises(RuntimeError):
        synthetic_device_corpus(1, 1, 8, 8)
    gen = Generator.from_config(conf, device="cpu")
    assert next(gen.model.parameters()).device.type == "cpu"
