"""Matrix-product precision scopes shared by the ops and their kernels."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["full_f32"]


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products in full float32 (no TF32) inside the block;
    the caller's setting is restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
