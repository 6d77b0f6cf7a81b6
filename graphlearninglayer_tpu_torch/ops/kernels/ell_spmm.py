"""Kernel P3: the gather SpMM of the symmetric-ELL matvec.

``ell_gather_spmm(nbr, val, x)`` returns the (m, l) slot sum

    out[i, c] = sum_s val[i, s] * x[nbr[i, s], c]

for ``nbr`` (m, S) int64 and ``val`` (m, S) in the port's ``SymEll``
layout (``ops/graph.py``: row-major slots, 0 and 0.0 on padding slots) and
``x`` (n, l); the rows of ``nbr`` may index any of the n rows of ``x`` (a
row-sharded solve passes its m = n / P local rows).  It is the slot sum of
``ops/graph.py::ell_spmm``, which the ELL eval solve
(``transductive_laplace(mode='ell')``) runs once a CG matvec, and of
``parallel/graph_shard.py::sharded_laplace_solve``'s matvec on every rank.
It replaces the Pallas TPU probe
``benchmarks/probe_pallas_gather.py::make_lane_gather.run`` (line 47),
which asked whether a lane gather from a VMEM-resident table could carry
that matvec; the JAX package's own ELL matvecs are XLA gathers.

* On a CUDA tensor it launches the hand-written Hopper kernel in
  ``csrc/ell_spmm.cu`` (its header states the bound and the design), or
  raises.  There is no fallback.  It takes int64 ``nbr``, float32 ``val``
  and ``x``, all contiguous, on one card.  It skips the slots whose value
  is 0 (their index is never read), so a non-finite row of ``x`` that
  only padding slots point at does not reach ``out``.
* On a CPU tensor it runs :func:`ell_gather_spmm_plain`, the same function
  in plain PyTorch, in the promoted dtype of ``val`` and ``x``.

``ell_gather_spmm.launches`` counts kernel launches; the plain version
never moves it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["ell_gather_spmm", "ell_gather_spmm_plain"]


def ell_gather_spmm_plain(nbr: torch.Tensor, val: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """P3 in plain PyTorch: the CPU path, and the yardstick the kernel is
    held against on the card."""
    dt = torch.promote_types(val.dtype, x.dtype)
    return torch.sum(val.to(dt)[:, :, None] * x.to(dt)[nbr], dim=1)


def _check(nbr: torch.Tensor, val: torch.Tensor, x: torch.Tensor) -> None:
    if nbr.dim() != 2 or x.dim() != 2 or tuple(val.shape) != tuple(
            nbr.shape):
        raise ValueError(f"nbr and val must be (m, S) and x (n, l); got "
                         f"{tuple(nbr.shape)}, {tuple(val.shape)}, "
                         f"{tuple(x.shape)}")
    if not (nbr.device == val.device == x.device):
        raise ValueError(f"nbr, val and x must share one device, got "
                         f"{nbr.device}, {val.device}, {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"P3 runs on CUDA or CPU tensors, got {x.device}")


_fn = None


def _kernel():
    """The C entry point of ``csrc/ell_spmm.cu``, built and typed on first
    use."""
    global _fn
    if _fn is None:
        fn = _build.load("ell_spmm").gll_ell_gather_spmm_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(nbr: torch.Tensor, val: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    if nbr.dtype != torch.int64:
        raise TypeError(f"the P3 kernel takes int64 nbr; nbr is {nbr.dtype}")
    for name, t in (("val", val), ("x", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"the P3 kernel takes float32; {name} is "
                            f"{t.dtype}")
    for name, t in (("nbr", nbr), ("val", val), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"the P3 kernel takes contiguous tensors; "
                             f"{name} is not")
    m, s = nbr.shape
    l = x.shape[1]
    if max(m, s, l, x.shape[0]) >= 2 ** 31:
        raise ValueError(f"the P3 kernel takes sizes below 2**31; got nbr "
                         f"{tuple(nbr.shape)}, x {tuple(x.shape)}")
    out = torch.empty((m, l), dtype=torch.float32, device=x.device)
    if m == 0 or l == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(nbr.data_ptr(), val.data_ptr(), x.data_ptr(), out.data_ptr(),
                 m, s, l, stream)
    if err != 0:
        raise RuntimeError(f"P3 ELL gather kernel launch failed with CUDA "
                           f"error {err} (m={m}, S={s}, l={l})")
    ell_gather_spmm.launches += 1
    return out


def ell_gather_spmm(nbr: torch.Tensor, val: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """P3: the (m, l) slot sum of ``val`` and the rows ``nbr`` of ``x``; see
    the module docstring.  CUDA tensors go to the kernel, CPU tensors to
    the plain version."""
    _check(nbr, val, x)
    if x.device.type == "cpu":
        return ell_gather_spmm_plain(nbr, val, x)
    return _launch(nbr, val, x)


ell_gather_spmm.launches = 0
