"""Kernel P3: the gather SpMM of the symmetric-ELL matvec.

``ell_gather_spmm(nbr, val, x, counts)`` returns the (m, l) slot sum

    out[i, c] = sum_{s < counts[i]} val[i, s] * x[nbr[i, s], c]

for ``nbr`` (m, S) int64 and ``val`` (m, S) in the port's ``SymEll``
layout (``ops/graph.py``: row-major slots packed to the front, 0 and 0.0
on padding slots), ``counts`` (m,) int32 each row's slots in use
(``SymEll.cnt``: k out-edges plus its in-edges; None counts all S) and
``x`` (n, l); the rows of ``nbr`` may index any of the n rows of ``x`` (a
row-sharded solve passes its m = n / P local rows).  Since the slots past
a row's count are padding, the sum over them is the sum over all S.  It
is the slot sum of ``ops/graph.py::ell_spmm``, which the ELL eval solve
(``transductive_laplace(mode='ell')``) runs once a CG matvec, and of
``parallel/graph_shard.py::sharded_laplace_solve``'s matvec on every rank.
It replaces the Pallas TPU probe
``benchmarks/probe_pallas_gather.py::make_lane_gather.run`` (line 47),
which asked whether a lane gather from a VMEM-resident table could carry
that matvec; the JAX package's own ELL matvecs are XLA gathers.

* On a CUDA tensor it launches the hand-written Hopper kernel in
  ``csrc/ell_spmm.cu`` (its header states the bound and the design), or
  raises.  There is no fallback.  It takes int64 ``nbr``, float32 ``val``
  and ``x`` and int32 ``counts``, all contiguous, on one card.  It reads
  no slot past a row's count and gathers no row of ``x`` for a slot whose
  value is 0, so a non-finite row of ``x`` that only padding or masked
  slots point at does not reach ``out``.
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
                          x: torch.Tensor,
                          counts: torch.Tensor | None = None) -> torch.Tensor:
    """P3 in plain PyTorch: the CPU path, and the yardstick the kernel is
    held against on the card.  With ``counts`` only the slots below each
    row's count enter the sum, and none past the largest count is read."""
    dt = torch.promote_types(val.dtype, x.dtype)
    val = val.to(dt)
    if counts is not None:
        width = int(counts.max()) if counts.numel() else 0
        nbr, val = nbr[:, :width], val[:, :width]
        slot = torch.arange(width, device=val.device)
        val = torch.where(slot[None, :] < counts[:, None], val, 0.0)
    return torch.sum(val[:, :, None] * x.to(dt)[nbr], dim=1)


def _check(nbr: torch.Tensor, val: torch.Tensor, x: torch.Tensor,
           counts: torch.Tensor | None) -> None:
    if nbr.dim() != 2 or x.dim() != 2 or tuple(val.shape) != tuple(
            nbr.shape):
        raise ValueError(f"nbr and val must be (m, S) and x (n, l); got "
                         f"{tuple(nbr.shape)}, {tuple(val.shape)}, "
                         f"{tuple(x.shape)}")
    if counts is not None and tuple(counts.shape) != (nbr.shape[0],):
        raise ValueError(f"counts must be (m,) = ({nbr.shape[0]},); got "
                         f"{tuple(counts.shape)}")
    devices = {t.device for t in (nbr, val, x, counts) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"nbr, val, x and counts must share one device, "
                         f"got {sorted(map(str, devices))}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"P3 runs on CUDA or CPU tensors, got {x.device}")


_fn = None


def _kernel():
    """The C entry point of ``csrc/ell_spmm.cu``, built and typed on first
    use."""
    global _fn
    if _fn is None:
        fn = _build.load("ell_spmm").gll_ell_gather_spmm_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(nbr: torch.Tensor, val: torch.Tensor, x: torch.Tensor,
            counts: torch.Tensor | None) -> torch.Tensor:
    if nbr.dtype != torch.int64:
        raise TypeError(f"the P3 kernel takes int64 nbr; nbr is {nbr.dtype}")
    for name, t in (("val", val), ("x", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"the P3 kernel takes float32; {name} is "
                            f"{t.dtype}")
    if counts is not None and counts.dtype != torch.int32:
        raise TypeError(f"the P3 kernel takes int32 counts; counts is "
                        f"{counts.dtype}")
    for name, t in (("nbr", nbr), ("val", val), ("x", x), ("counts", counts)):
        if t is not None and not t.is_contiguous():
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
        err = fn(nbr.data_ptr(), val.data_ptr(),
                 None if counts is None else counts.data_ptr(), x.data_ptr(),
                 out.data_ptr(), m, s, l, stream)
    if err != 0:
        raise RuntimeError(f"P3 ELL gather kernel launch failed with CUDA "
                           f"error {err} (m={m}, S={s}, l={l})")
    ell_gather_spmm.launches += 1
    return out


def ell_gather_spmm(nbr: torch.Tensor, val: torch.Tensor, x: torch.Tensor,
                    counts: torch.Tensor | None = None) -> torch.Tensor:
    """P3: the (m, l) slot sum of ``val`` and the rows ``nbr`` of ``x``
    over each row's ``counts`` slots (all S without); see the module
    docstring.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    _check(nbr, val, x, counts)
    if x.device.type == "cpu":
        return ell_gather_spmm_plain(nbr, val, x, counts)
    return _launch(nbr, val, x, counts)


ell_gather_spmm.launches = 0
