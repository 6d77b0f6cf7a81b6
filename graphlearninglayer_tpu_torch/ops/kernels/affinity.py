"""Kernels K1 and K3: the fused affinity of the dense graph op.

``fused_affinity_sym(x, eps, m_raw)`` returns the masked affinity

    W[i, j] = exp(-4 d2_ij / (eps_i eps_j)) * max(M, M^T)[i, j]
              * [i != j] * [d2_ij > 0],
    d2_ij   = max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0)

from features ``x`` (n, d), bandwidths ``eps`` (n,) and the RAW directed KNN
indicator ``m_raw`` (n, n) (``m_raw[i, nbr[i]] = 1``).  It replaces the Pallas
TPU kernel ``graphlearninglayer_tpu/ops/kernels/affinity.py::
fused_affinity_sym``.

* On a CUDA tensor it launches the hand-written Hopper kernel in
  ``csrc/affinity_sym.cu`` (its header states the bound and the design), or
  raises.  There is no fallback.
* On a CPU tensor it runs :func:`fused_affinity_sym_plain`, the same function
  in plain PyTorch, in the input's dtype.

``fused_affinity(x, eps, mask)`` (K3) returns

    W[i, j] = exp(-4 d2_ij / (eps_i eps_j)) * mask[i, j]

for a precomputed {0, 1} ``mask`` (n, n), with no symmetrization and no
self or zero-distance exclusion.  It replaces the Pallas TPU kernel
``graphlearninglayer_tpu/ops/kernels/affinity.py::fused_affinity``, which no
path of the JAX package calls (its tests only); no path of the port calls it
either.  Both kernels share one CUDA source, a template flag apart.

``fused_affinity_sym.launches`` and ``fused_affinity.launches`` count kernel
launches; the plain versions never move them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_affinity_sym", "fused_affinity_sym_plain", "fused_affinity",
           "fused_affinity_plain"]


def fused_affinity_sym_plain(x: torch.Tensor, eps: torch.Tensor,
                             m_raw: torch.Tensor) -> torch.Tensor:
    """K1 in plain PyTorch: the CPU path, and the yardstick the kernel is
    held against on the card."""
    n = x.shape[0]
    sq = torch.sum(x * x, dim=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0)
    mask = torch.maximum(m_raw, m_raw.T)
    off_diag = ~torch.eye(n, dtype=torch.bool, device=x.device)
    mask = torch.where(off_diag & (d2 > 0.0), mask, torch.zeros_like(mask))
    inv = 1.0 / (eps[:, None] * eps[None, :])
    return torch.exp(-4.0 * d2 * inv) * mask


def fused_affinity_plain(x: torch.Tensor, eps: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """K3 in plain PyTorch: the CPU path, and the yardstick the kernel is
    held against on the card."""
    sq = torch.sum(x * x, dim=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0)
    inv = 1.0 / (eps[:, None] * eps[None, :])
    return torch.exp(-4.0 * d2 * inv) * mask


def _check(x: torch.Tensor, eps: torch.Tensor, m: torch.Tensor,
           kernel: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    n = x.shape[0]
    if tuple(eps.shape) != (n,) or tuple(m.shape) != (n, n):
        raise ValueError(f"shapes do not match x {tuple(x.shape)}: eps "
                         f"{tuple(eps.shape)}, mask {tuple(m.shape)}")
    if not (eps.device == x.device == m.device):
        raise ValueError(f"x, eps and the mask must share one device, got "
                         f"{x.device}, {eps.device}, {m.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got "
                         f"{x.device}")


_kernel_fns: dict[str, object] = {}


def _kernel(entry: str):
    """A C entry point of ``csrc/affinity_sym.cu``, built and typed on first
    use."""
    fn = _kernel_fns.get(entry)
    if fn is None:
        fn = getattr(_build.load("affinity_sym"), entry)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fns[entry] = fn
    return fn


def _launch(kernel: str, entry: str, x: torch.Tensor, eps: torch.Tensor,
            m: torch.Tensor) -> torch.Tensor:
    for name, t in (("x", x), ("eps", eps), ("mask", m)):
        if t.dtype != torch.float32:
            raise TypeError(f"the {kernel} kernel takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {kernel} kernel takes contiguous tensors; "
                             f"{name} is not")
    n, d = x.shape
    fn = _kernel(entry)
    w = torch.empty((n, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), eps.data_ptr(), m.data_ptr(), w.data_ptr(),
                 n, d, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} affinity kernel launch failed with CUDA "
                           f"error {err} (n={n}, d={d})")
    return w


def fused_affinity_sym(x: torch.Tensor, eps: torch.Tensor,
                       m_raw: torch.Tensor) -> torch.Tensor:
    """K1: masked symmetrized affinity W (n, n); see the module docstring.

    CUDA tensors must be float32 and contiguous and go to the kernel; CPU
    tensors go to the plain version."""
    _check(x, eps, m_raw, "K1")
    if x.device.type == "cpu":
        return fused_affinity_sym_plain(x, eps, m_raw)
    w = _launch("K1", "gll_affinity_sym_f32", x, eps, m_raw)
    fused_affinity_sym.launches += 1
    return w


def fused_affinity(x: torch.Tensor, eps: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """K3: affinity W (n, n) times a precomputed {0, 1} mask; see the module
    docstring.  Any n and d, no padding.

    CUDA tensors must be float32 and contiguous and go to the kernel; CPU
    tensors go to the plain version."""
    _check(x, eps, mask, "K3")
    if x.device.type == "cpu":
        return fused_affinity_plain(x, eps, mask)
    w = _launch("K3", "gll_affinity_f32", x, eps, mask)
    fused_affinity.launches += 1
    return w


fused_affinity_sym.launches = 0
fused_affinity.launches = 0
