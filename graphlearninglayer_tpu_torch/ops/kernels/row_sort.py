"""Kernel P1: a bitonic sort of each row in one block, and a scale gated on
a reduced scalar.

``row_sort(x, descending=False)`` returns ``(values, indices)`` of each row
of ``x`` (Q, M), M a power of two up to 1,024, sorted by (value, column
index), or by (-value, column index) when ``descending``: of equal values
the lower index comes first either way, which is ``torch.sort(...,
stable=True)``'s order.  Descending over a whole row is the probe's
``lax.top_k(x, M)``.  ``scale_if_max_positive(x)`` returns ``2 x`` where the
array's max is above 0, else ``x``: the probe's ``pl.when(scalar)`` case.

They replace the Pallas TPU probe ``benchmarks/probe_pallas_sort.py::run``
(line 25), which asked whether Mosaic compiles an in-kernel sort, a full
``lax.top_k``, a bitonic compare-exchange network and ``pl.when`` on a
reduced scalar, on a 256 x 512 float32 block.  No path of the port calls
them.

* On a CUDA tensor each launches its hand-written Hopper kernel in
  ``csrc/row_sort.cu`` (its header states the bound and the design), or
  raises.  There is no fallback.  They take float32, contiguous.
* On a CPU tensor each runs its plain version, :func:`row_sort_plain` or
  :func:`scale_if_max_positive_plain`.

``row_sort.launches`` and ``scale_if_max_positive.launches`` count kernel
launches (one a call); the plain versions never move them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["row_sort", "row_sort_plain", "scale_if_max_positive",
           "scale_if_max_positive_plain", "MAX_M"]

MAX_M = 1024    # a row in one block's shared memory


def row_sort_plain(x: torch.Tensor, descending: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """P1's sort in plain PyTorch: the CPU path, and the yardstick the
    kernel is held against on the card."""
    out = torch.sort(x, dim=1, descending=descending, stable=True)
    return out.values, out.indices


def scale_if_max_positive_plain(x: torch.Tensor) -> torch.Tensor:
    """P1's gated scale in plain PyTorch."""
    return torch.where(x.max() > 0, 2 * x, x)


def _check(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if x.device.type == "cuda":
        if x.dtype != torch.float32:
            raise TypeError(f"the {what} kernel takes float32; x is "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"the {what} kernel takes a contiguous x")


_fns: dict[str, object] = {}


def _kernel(entry: str, argtypes: list):
    """A C entry point of ``csrc/row_sort.cu``, built and typed on first
    use."""
    fn = _fns.get(entry)
    if fn is None:
        fn = getattr(_build.load("row_sort"), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def row_sort(x: torch.Tensor, descending: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """P1's sort: ``(values, indices)`` of each row of ``x`` (Q, M); see the
    module docstring.  CUDA tensors go to the kernel, CPU tensors to the
    plain version."""
    if x.dim() != 2:
        raise ValueError(f"x must be (Q, M), got shape {tuple(x.shape)}")
    q, m = x.shape
    if not (1 <= m <= MAX_M and m & (m - 1) == 0):
        raise ValueError(f"row_sort takes rows of a power of two up to "
                         f"{MAX_M} entries, got {m}")
    _check(x, "P1 row sort")
    if x.device.type == "cpu":
        return row_sort_plain(x, descending)
    if q >= 2 ** 31:
        raise ValueError(f"the P1 kernel takes fewer than 2**31 rows, got "
                         f"{q}")
    vals = torch.empty_like(x)
    idx = torch.empty((q, m), dtype=torch.int64, device=x.device)
    if q == 0:
        return vals, idx
    fn = _kernel("gll_row_sort_f32",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), q, m,
                 int(descending), stream)
    if err != 0:
        raise RuntimeError(f"P1 row sort kernel launch failed with CUDA "
                           f"error {err} (Q={q}, M={m})")
    row_sort.launches += 1
    return vals, idx


def scale_if_max_positive(x: torch.Tensor) -> torch.Tensor:
    """P1's gated scale: ``2 x`` where ``x.max() > 0``, else ``x``, for a
    non-empty ``x`` of any shape; see the module docstring.  CUDA tensors
    go to the kernel, CPU tensors to the plain version."""
    if x.numel() == 0:
        raise ValueError("scale_if_max_positive takes a non-empty x")
    _check(x, "P1 gated scale")
    if x.device.type == "cpu":
        return scale_if_max_positive_plain(x)
    out = torch.empty_like(x)
    flag = torch.empty((1,), dtype=torch.int32, device=x.device)
    fn = _kernel("gll_scale_if_max_positive_f32",
                 [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), flag.data_ptr(), x.numel(),
                 stream)
    if err != 0:
        raise RuntimeError(f"P1 gated scale kernel launch failed with CUDA "
                           f"error {err} ({x.numel()} elements)")
    scale_if_max_positive.launches += 1
    return out


row_sort.launches = 0
scale_if_max_positive.launches = 0
