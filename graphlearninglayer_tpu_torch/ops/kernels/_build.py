"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C functions.  ``nvcc`` compiles it into
``build/torch_kernels/lib<name>-<hash>.so`` at the repository root (a
directory that ``.gitignore`` lists) the first time a wrapper needs it, and
``ctypes`` loads it.  The hash covers the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing here runs at
import time: the CPU tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(name: str) -> tuple[float, str] | None:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns
    ``(seconds, ptxas report)`` when it compiled, None when the library was
    there; raises if ``nvcc`` fails."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
