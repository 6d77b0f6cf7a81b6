"""Linear solvers of the graph Laplace system.

Twin of ``graphlearninglayer_tpu/ops/solve.py``.  Two regimes:

  * **Direct dense solve** (``CholeskyFactor``, ``cholesky_factor``,
    ``cholesky_solve``): the per-batch training op factorizes
    ``Luu + tau I`` once and reuses the factor for the backward's adjoint
    solve.
  * **Column-masked multi-RHS CG** (``stable_conjgrad``): the transductive
    eval's large graphs, where densifying is impossible.

The factorization is ``torch.linalg.cholesky_ex``: unlike
``torch.linalg.cholesky`` it does not synchronize with the host to check
the result.  Its ``info`` (0 on success, else the order of the first
non-positive leading minor) stays a device tensor for the caller to report.

CG's trace (``utils/profiling.py``): ``stable_conjgrad.iterations`` counts
every iteration of every solve; each residual check on the host is a span
``eval.cg.check`` and a ``host_sync("solve.cg_check")``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.profiling import annotate, host_sync

__all__ = ["CholeskyFactor", "cholesky_factor", "cholesky_solve",
           "stable_conjgrad"]


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


def stable_conjgrad(matvec: Callable[[torch.Tensor], torch.Tensor],
                    b: torch.Tensor, x0: torch.Tensor | None = None,
                    max_iter: int = 100_000, tol: float = 1e-10,
                    return_info: bool = False,
                    colsum: Callable[[torch.Tensor], torch.Tensor]
                    | None = None):
    """Column-masked multi-RHS conjugate gradient (the reference's
    ``stable_conjgrad`` semantics):

      * per-column ``alpha``/``beta`` are zeroed once that column's ``rs``
        falls to ``tol**2`` (the column stops moving);
      * the solve stops when ``max_col ||r_col|| <= tol`` or after
        ``max_iter`` iterations.

    ``matvec`` is a linear operator on (m, l) tensors, applied column-wise;
    ``b`` is (m, l).  ``tol`` is taken in ``b``'s dtype, as the JAX package
    does.  The loop checks the residual on the host before every iteration
    and after the last: iterations + 1 checks when the residual ends the
    solve, iterations when ``max_iter`` does.
    ``return_info=True`` returns ``(x, iterations, final residual)``, the
    residual as a 0-d tensor.  ``colsum``: the (l,) column sums of an
    (m, l) tensor (``torch.sum(v, dim=0)`` by default); a row-sharded
    solve passes one that all-reduces them, so that every rank sees the
    same alpha, beta and residual and stops at the same iteration
    (``parallel/``).
    """
    if colsum is None:
        colsum = lambda v: torch.sum(v, dim=0)
    if x0 is None:
        x0 = torch.zeros_like(b)
    # a CPU scalar: the device ops take it as an argument, with no copy
    tol_t = torch.tensor(tol, dtype=b.dtype)
    tol2 = tol_t * tol_t

    x = x0
    r = b - matvec(x0)
    p = r
    rs = colsum(r * r)
    err = torch.sqrt(torch.max(rs))
    iters = 0
    while iters < max_iter and _above(err, tol_t):
        ap = matvec(p)
        pap = colsum(p * ap)
        live = rs > tol2
        alpha = torch.where(live, rs / torch.where(live, pap, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rsnew = colsum(r * r)
        err = torch.sqrt(torch.max(rsnew))
        livenew = rsnew > tol2
        beta = torch.where(livenew, rsnew / torch.where(livenew, rs, 1.0),
                           0.0)
        p = r + beta * p
        rs = rsnew
        iters += 1
        stable_conjgrad.iterations += 1
    if return_info:
        return x, iters, err
    return x


stable_conjgrad.iterations = 0


def _above(err: torch.Tensor, tol_t: torch.Tensor) -> bool:
    """CG's residual check, read on the host."""
    with annotate("eval.cg.check"):
        host_sync("solve.cg_check")
        return bool(err > tol_t)
