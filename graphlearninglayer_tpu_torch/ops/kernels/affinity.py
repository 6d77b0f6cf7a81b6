"""Kernel K1: the fused, union-symmetrized affinity of the dense graph op.

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

``fused_affinity_sym.launches`` counts kernel launches; the plain version
never moves it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_affinity_sym", "fused_affinity_sym_plain"]


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


def _check(x: torch.Tensor, eps: torch.Tensor, m_raw: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    n = x.shape[0]
    if tuple(eps.shape) != (n,) or tuple(m_raw.shape) != (n, n):
        raise ValueError(f"shapes do not match x {tuple(x.shape)}: eps "
                         f"{tuple(eps.shape)}, m_raw {tuple(m_raw.shape)}")
    if not (eps.device == x.device == m_raw.device):
        raise ValueError(f"x, eps and m_raw must share one device, got "
                         f"{x.device}, {eps.device}, {m_raw.device}")


_kernel_fn = None


def _kernel():
    """The C entry point of ``csrc/affinity_sym.cu``, built and typed on
    first use."""
    global _kernel_fn
    if _kernel_fn is None:
        fn = _build.load("affinity_sym").gll_affinity_sym_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _launch(x: torch.Tensor, eps: torch.Tensor,
            m_raw: torch.Tensor) -> torch.Tensor:
    for name, t in (("x", x), ("eps", eps), ("m_raw", m_raw)):
        if t.dtype != torch.float32:
            raise TypeError(f"the K1 kernel takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the K1 kernel takes contiguous tensors; "
                             f"{name} is not")
    n, d = x.shape
    fn = _kernel()
    w = torch.empty((n, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), eps.data_ptr(), m_raw.data_ptr(), w.data_ptr(),
                 n, d, stream)
    if err != 0:
        raise RuntimeError(f"K1 affinity kernel launch failed with CUDA "
                           f"error {err} (n={n}, d={d})")
    fused_affinity_sym.launches += 1
    return w


def fused_affinity_sym(x: torch.Tensor, eps: torch.Tensor,
                       m_raw: torch.Tensor) -> torch.Tensor:
    """Masked symmetrized affinity W (n, n); see the module docstring.

    CUDA tensors must be float32 and contiguous and go to the kernel; CPU
    tensors go to the plain version."""
    _check(x, eps, m_raw)
    if x.device.type == "cpu":
        return fused_affinity_sym_plain(x, eps, m_raw)
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, got {x.device}")
    return _launch(x, eps, m_raw)


fused_affinity_sym.launches = 0
