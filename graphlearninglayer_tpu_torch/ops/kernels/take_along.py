"""Kernel P2: ``take_along_axis`` with indices shaped like the operand.

``take_along(x, idx, axis)`` returns, for ``x`` (m, n) and ``idx`` (m, n)
int64,

    axis 0: out[i, j] = x[idx[i, j], j]
    axis 1: out[i, j] = x[i, idx[i, j]]

which is ``numpy.take_along_axis`` and ``torch.gather(x, axis, idx)``.  It
replaces the Pallas TPU probe ``benchmarks/probe_gather_support.py::
try_case`` (line 19), which asked which shapes Mosaic compiles
``jnp.take_along_axis`` for inside a kernel (the probe's six cases run from
256 x 128 to 65,536 x 128).  No path of the port calls it.

* On a CUDA tensor it launches the hand-written Hopper kernel in
  ``csrc/take_along.cu`` (its header states the bound and the design), or
  raises.  There is no fallback.  It takes float32 ``x`` and int64
  ``idx``, both contiguous.  An index out of range gives NaN at its place
  (the plain version raises there).
* On a CPU tensor it runs :func:`take_along_plain`, ``torch.gather``.

``take_along.launches`` counts kernel launches; the plain version never
moves it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["take_along", "take_along_plain"]


def take_along_plain(x: torch.Tensor, idx: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """P2 in plain PyTorch: the CPU path, and the yardstick the kernel is
    held against on the card."""
    return torch.gather(x, axis, idx)


_fn = None


def _kernel():
    """The C entry point of ``csrc/take_along.cu``, built and typed on
    first use."""
    global _fn
    if _fn is None:
        fn = _build.load("take_along").gll_take_along_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def take_along(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """P2: ``take_along_axis(x, idx, axis)`` for axis 0 or 1; see the module
    docstring.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    if x.dim() != 2 or tuple(idx.shape) != tuple(x.shape):
        raise ValueError(f"x and idx must be (m, n) alike, got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if x.device != idx.device:
        raise ValueError(f"x and idx must share one device, got {x.device} "
                         f"and {idx.device}")
    if x.device.type == "cpu":
        return take_along_plain(x, idx, axis)
    if x.device.type != "cuda":
        raise ValueError(f"P2 runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the P2 kernel takes float32; x is {x.dtype}")
    if idx.dtype != torch.int64:
        raise TypeError(f"the P2 kernel takes int64 indices; idx is "
                        f"{idx.dtype}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the P2 kernel takes a contiguous x and idx")
    m, n = x.shape
    if max(m, n) >= 2 ** 31:
        raise ValueError(f"the P2 kernel takes sizes below 2**31, got "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), m, n, axis,
                 stream)
    if err != 0:
        raise RuntimeError(f"P2 take-along kernel launch failed with CUDA "
                           f"error {err} ({m} x {n}, axis {axis})")
    take_along.launches += 1
    return out


take_along.launches = 0
