"""Dense Cholesky solve of the graph Laplace system.

Twin of ``graphlearninglayer_tpu/ops/solve.py`` (``CholeskyFactor``,
``cholesky_factor``, ``cholesky_solve``).  The per-batch training op
factorizes ``Luu + tau I`` once and reuses the factor for the backward's
adjoint solve.

The factorization is ``torch.linalg.cholesky_ex``: unlike
``torch.linalg.cholesky`` it does not synchronize with the host to check
the result.  Its ``info`` (0 on success, else the order of the first
non-positive leading minor) stays a device tensor for the caller to report.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CholeskyFactor", "cholesky_factor", "cholesky_solve"]


class CholeskyFactor(NamedTuple):
    """Lower-triangular Cholesky factor of an SPD matrix, with the
    factorization's ``info`` as a device scalar."""

    chol: torch.Tensor
    info: torch.Tensor

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return torch.cholesky_solve(b, self.chol, upper=False)


def cholesky_factor(a: torch.Tensor) -> CholeskyFactor:
    """Factorize SPD ``a`` once; reuse for forward and backward solves."""
    chol, info = torch.linalg.cholesky_ex(a)
    return CholeskyFactor(chol, info)


def cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return cholesky_factor(a).solve(b)
