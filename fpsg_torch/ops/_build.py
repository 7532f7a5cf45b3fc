"""Build the CUDA kernels from ``fpsg_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/fpsg_torch/lib<name>_<digest>.so`` at the root of the
checkout (git-ignored), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

The digest covers the source and the flags, so an edited kernel is built
anew and an unchanged one is reused. The libraries are loaded with
``ctypes``; every C entry point returns ``cudaGetLastError()`` after its
launch, and the wrapper raises on anything but 0.

Nothing here runs at import time of the kernel wrappers: they import this
module inside the function that launches, so the CPU-only tests never
reach ``nvcc``. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fpsg_torch"
SOURCES = ("maxpool2x2", "fused_stack", "chamfer", "segment_sum", "moments",
           "pool_moments", "sinkhorn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every library in ``names`` that is not built yet: one
    ``nvcc`` per source, all started together. Returns, per source, the
    wall seconds of its build (0.0 when reused) and the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    report: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "reused " + out.name}
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C function to its ``argtypes``; every
    function returns ``int`` (a ``cudaError_t``)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.fpsg_error_string.argtypes = [ctypes.c_int]
            lib.fpsg_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.fpsg_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
