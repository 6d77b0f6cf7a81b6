"""The graph Laplace-learning op with its implicit-differentiation backward.

Twin of ``graphlearninglayer_tpu/ops/laplace.py``.  Semantics
(reference ``LaplaceLearningSparseHard``):

  Forward: given features X (n, d) whose first ``k_lab`` rows are labeled
  with one-hot Y (k_lab, l):
    1. build the symmetrized KNN affinity graph W over all n rows
       (k neighbors, bandwidth eps per ``epsilon``),
    2. form L = D - W, slice Luu = L[k:, k:] (+ tau I) and Lul = L[k:, :k],
    3. solve Luu P = -Lul Y and return P (m, l) for the unlabeled rows.

  Backward: hand-derived implicit differentiation (``dense_backward``),
  including the auto-eps term with the k-th-neighbor selection held fixed.
  Every row of X gets a gradient, labeled rows included; Y gets none.

Two modes, each a ``torch.autograd.Function``:

  * **dense** (``_LaplaceDense``, n <= 4096 with the Cholesky solver): all
    n x n matrix math (``dense_mode.py``).  The forward keeps W, the Cholesky
    factor and P for the backward, so one factorization serves both passes.
  * **edge** (``_LaplaceEdge``, n > 4096 or ``solver='cg'``): the fixed
    (n, k) edge list of ``graph.py``.  ``solver='cholesky'`` densifies Luu
    and keeps its factor for the adjoint solve; ``solver='cg'`` runs the
    Jacobi-preconditioned ``stable_conjgrad`` on both sides, M Luu M with
    M = diag(Luu)^(-1/2), and the adjoint solve applies the same
    preconditioned operator.  Each CG solve checks its residual on the host
    once per iteration.  The per-edge sums of the backward accumulate
    duplicate indices with ``index_add``.

The exploding-gradient check is done on the host where a step's metrics are
read (:func:`warn_exploding_grad`), never inside the backward, so the
backward adds no host synchronization.

Spans (``utils/profiling.py``): ``gl.op.forward``, holding ``gl.op.knn``
(distances and selection), ``gl.op.affinity`` (W; K1 in dense mode) and
``gl.op.solve`` (the system and its solve), and ``gl.op.backward``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import annotate
from .dense_mode import DenseGraph, build_dense_graph, dense_backward, \
    dense_forward
from .graph import (BatchGraph, build_graph, dense_weight_matrix,
                    edge_weights, sym_rowsum, sym_spmm)
from .solve import CholeskyFactor, cholesky_factor, stable_conjgrad

__all__ = ["LaplaceConfig", "laplace_learning", "GRAD_NORM_WARN_THRESHOLD",
           "warn_exploding_grad"]

# The reference warns when ||dX||_F > 10 after the op's backward.  Set to
# 0/None to disable.
GRAD_NORM_WARN_THRESHOLD: float | None = 10.0

DENSE_MAX_N = 4096


class LaplaceConfig(NamedTuple):
    """Hyperparameters of the Laplace-learning op.

    tau:        diagonal regularizer added to Luu.  FullySup passes ``--temp``
                (0.07); the adversarial drivers use 0.
    epsilon:    'auto' for the self-tuning bandwidth (k-th NN distance) or a
                float.
    k:          neighbors per node, self included.
    solver:     'cholesky' (direct) or 'cg' (matrix-free, edge mode only).
    cg_tol, cg_max_iter: the CG stopping rule (max column residual norm,
                in the features' dtype).
    use_kernel: 'auto', the only mode: K1 on CUDA tensors, its plain
                version on CPU tensors (dense mode).
    """

    tau: float = 0.0
    epsilon: str | float = "auto"
    k: int = 25
    solver: str = "cholesky"
    cg_tol: float = 1e-10
    cg_max_iter: int = 100_000
    use_kernel: str = "auto"

    @property
    def auto_eps(self) -> bool:
        return isinstance(self.epsilon, str) and self.epsilon == "auto"


class _LaplaceDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, cfg: LaplaceConfig, stats: dict | None):
        with annotate("gl.op.forward"):
            with annotate("gl.op.knn"):
                g = build_dense_graph(x, cfg.k, cfg.epsilon)
            pred, (w, _, factor) = dense_forward(g, y, cfg.tau, x,
                                                 cfg.use_kernel)
        # W is kept in the slot the JAX residuals call ``deg``
        ctx.save_for_backward(x, y, g.m_raw, g.d2, g.eps, g.nbr, w,
                              factor.chol, factor.info, pred)
        ctx.cfg = cfg
        ctx.stats = stats
        if stats is not None:
            stats["chol_info"] = factor.info
        return pred

    @staticmethod
    def backward(ctx, gbar):
        x, y, m_raw, d2, eps, nbr, w, chol, info, pred = ctx.saved_tensors
        g = DenseGraph(m_raw=m_raw, d2=d2, eps=eps, nbr=nbr)
        with annotate("gl.op.backward"):
            gx = dense_backward(g, y, pred, x, CholeskyFactor(chol, info),
                                gbar, ctx.cfg.auto_eps, w=w)
            if ctx.stats is not None:
                ctx.stats["grad_norm"] = torch.linalg.vector_norm(gbar)
                ctx.stats["out_norm"] = torch.linalg.vector_norm(gx)
        return gx, None, None, None


def _rhs(g: BatchGraph, w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """-Lul @ Y = W[k:, :k] @ Y, matrix-free via the edge structure."""
    k_lab = y.shape[0]
    y_full = torch.cat([y, y.new_zeros((g.n - k_lab, y.shape[1]))])
    return sym_spmm(g, w, y_full)[k_lab:]


def _luu_matvec(g: BatchGraph, w, deg, tau: float, k_lab: int):
    """Matrix-free application of Luu + tau I to (m, l) blocks."""

    def mv(p):
        p_full = torch.cat([p.new_zeros((k_lab, p.shape[1])), p])
        wp = sym_spmm(g, w, p_full)[k_lab:]
        return (deg[k_lab:] + tau)[:, None] * p - wp

    return mv


def _solve_luu(cfg: LaplaceConfig, g: BatchGraph, w, deg, k_lab: int, rhs,
               factor: CholeskyFactor | None = None):
    """Solve (Luu + tau I) Z = rhs.  Returns ``(Z, factor, cg_iters)``: the
    Cholesky factor to reuse (None for CG) and the CG iterations (None for
    Cholesky)."""
    if cfg.solver == "cholesky":
        if factor is None:
            wd = dense_weight_matrix(g, w)
            luu = torch.diag(deg[k_lab:] + cfg.tau) - wd[k_lab:, k_lab:]
            factor = cholesky_factor(luu)
        return factor.solve(rhs.to(factor.chol.dtype)), factor, None
    if cfg.solver == "cg":
        # Jacobi preconditioning on both sides, as the reference eval path
        # does: solve M Luu M z = M rhs and return M z, M = diag(Luu)^(-1/2)
        mscale = (1.0 / torch.sqrt(deg[k_lab:] + cfg.tau + 1e-10))[:, None]
        mv = _luu_matvec(g, w, deg, cfg.tau, k_lab)
        z, iters, _ = stable_conjgrad(
            lambda p: mscale * mv(mscale * p), mscale * rhs.to(w.dtype),
            max_iter=cfg.cg_max_iter, tol=cfg.cg_tol, return_info=True)
        return mscale * z, None, iters
    raise ValueError(f"unknown solver {cfg.solver!r}")


class _LaplaceEdge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, cfg: LaplaceConfig, stats: dict | None):
        with annotate("gl.op.forward"):
            with annotate("gl.op.knn"):
                g = build_graph(x, cfg.k, cfg.epsilon)
            with annotate("gl.op.affinity"):
                w, _ = edge_weights(g)
                deg = sym_rowsum(g, w)
            with annotate("gl.op.solve"):
                pred, factor, iters = _solve_luu(cfg, g, w, deg, y.shape[0],
                                                 _rhs(g, w, y))
        chol = (factor.chol, factor.info) if factor is not None else ()
        ctx.save_for_backward(x, y, g.nbr, g.dist2, g.coef, g.eps, deg, pred,
                              *chol)
        ctx.cfg = cfg
        ctx.stats = stats
        if stats is not None:
            if factor is not None:
                stats["chol_info"] = factor.info
            else:
                stats["cg_iters"] = iters
        return pred

    @staticmethod
    def backward(ctx, gbar):
        with annotate("gl.op.backward"):
            x, y, nbr, dist2, coef, eps, deg, pred, *chol = ctx.saved_tensors
            cfg = ctx.cfg
            g = BatchGraph(nbr=nbr, dist2=dist2, coef=coef, eps=eps)
            n, k = nbr.shape
            k_lab = y.shape[0]
            w, v = edge_weights(g)
            # adjoint solve against the same regularized Luu: the forward's
            # factor, or the same preconditioned operator for CG
            factor = CholeskyFactor(*chol) if chol else None
            wu, _, iters = _solve_luu(cfg, g, w, deg, k_lab, gbar, factor)
            if ctx.stats is not None and iters is not None:
                ctx.stats["cg_iters_bwd"] = iters

            # pad the adjoint with zeros on labeled rows; labels above P
            wfull = torch.cat([wu.new_zeros((k_lab, wu.shape[1])), wu])
            f = torch.cat([y.to(pred.dtype), pred])

            # per-edge SDDMM: G_e = sum_c (w_i - w_j)(F_j - F_i)
            g_edge = torch.sum((wfull[:, None, :] - wfull[nbr])
                               * (f[nbr] - f[:, None, :]), dim=-1)  # (n, k)

            # dX = Lap(G o V) X: per directed edge with its
            # symmetrization coefficient, row i gets +t (x_i - x_j) and
            # row j gets -t (x_i - x_j)
            t = coef * g_edge * v
            weighted = t[:, :, None] * (x[:, None, :] - x[nbr])   # (n,k,d)
            flat = nbr.reshape(-1)
            gx = torch.sum(weighted, dim=1).index_add(
                0, flat, -weighted.reshape(n * k, -1))

            if cfg.auto_eps:
                # self-tuning-bandwidth term: b_i = sum_j G_ij mod_V_ij with
                # mod_V_ij = d^2 V_ij / (2 eps_i^2), then for each node u with
                # k-th neighbor K(u): dX_u += b_u (x_K - x_u), dX_K -= the same
                base = coef * g_edge * dist2 * v * 0.5
                b = torch.sum(base / (eps[:, None] ** 2), dim=1).index_add(
                    0, flat, (base / (eps[nbr] ** 2)).reshape(-1))
                kth = g.kth
                term = b[:, None] * (x[kth] - x)
                gx = (gx + term).index_add(0, kth, -term)

            if ctx.stats is not None:
                ctx.stats["grad_norm"] = torch.linalg.vector_norm(gbar)
                ctx.stats["out_norm"] = torch.linalg.vector_norm(gx)
            return gx, None, None, None


def laplace_learning(x: torch.Tensor, y: torch.Tensor, tau: float = 0.0,
                     epsilon="auto", k: int = 25, solver: str = "cholesky",
                     cg_tol: float = 1e-10, cg_max_iter: int = 100_000,
                     mode: str = "auto", use_kernel: str = "auto",
                     stats: dict | None = None) -> torch.Tensor:
    """Functional entry point mirroring ``LaplaceLearningSparseHard.apply``.

    x: (n, d) features, first ``y.shape[0]`` rows labeled; y: (k_lab, l)
    one-hot labels.  Returns (n - k_lab, l) predictions for unlabeled rows.
    ``mode='auto'`` picks dense mode for n <= 4096 with the Cholesky solver,
    and edge mode otherwise.

    ``stats``: an optional dict the op fills and never reads:
    ``chol_info`` (the forward's Cholesky info, a device scalar) or, for
    CG, ``cg_iters`` and, after the backward, ``cg_iters_bwd`` (host ints);
    after the backward, ``grad_norm`` (||dL/dP||) and ``out_norm``
    (||dL/dX||) as device scalars.
    """
    if mode == "auto":
        mode = "dense" if (solver == "cholesky"
                           and x.shape[0] <= DENSE_MAX_N) else "edge"
    if mode not in ("dense", "edge"):
        raise ValueError(f"unknown mode {mode!r}")
    if solver not in ("cholesky", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    if mode == "dense" and solver != "cholesky":
        raise ValueError("mode='dense' requires solver='cholesky'")
    cfg = LaplaceConfig(float(tau), epsilon if isinstance(epsilon, str)
                        else float(epsilon), int(k), solver, float(cg_tol),
                        int(cg_max_iter), use_kernel)
    op = _LaplaceDense if mode == "dense" else _LaplaceEdge
    return op.apply(x, y, cfg, stats)


def warn_exploding_grad(grad_norm: float, out_norm: float,
                        thresh: float | None | str = "default") -> bool:
    """Host-side exploding-gradient check on the norms a step reported.

    Prints the reference's message and returns True when ``out_norm``
    exceeds ``thresh``: 'default' takes :data:`GRAD_NORM_WARN_THRESHOLD`,
    and None or <= 0 disables."""
    if isinstance(thresh, str):
        thresh = GRAD_NORM_WARN_THRESHOLD
    if not thresh or thresh <= 0 or not out_norm > thresh:
        return False
    print(f"possible exploding gradient\ngrad norm: {grad_norm}\n"
          f"out norm: {out_norm}")
    return True
