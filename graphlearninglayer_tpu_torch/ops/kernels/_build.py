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


def build(*names: str) -> dict[str, tuple[float, str] | None]:
    """Compile each ``csrc/<name>.cu`` whose library does not exist, one
    ``nvcc`` per source, all started together.  Returns, per name,
    ``(seconds, ptxas report)`` when it compiled, None when the library was
    there; raises if any ``nvcc`` fails."""
    result: dict[str, tuple[float, str] | None] = dict.fromkeys(names)
    todo = [name for name in names if not _target(name).exists()]
    if not todo:
        return result
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in todo:
        out = _target(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit "
                          f"{proc.returncode}):\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        result[name] = (time.perf_counter() - t0, stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
