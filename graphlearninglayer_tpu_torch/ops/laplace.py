"""The graph Laplace-learning op with its implicit-differentiation backward.

Twin of ``graphlearninglayer_tpu/ops/laplace.py`` in dense mode.  Semantics
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

The op is a ``torch.autograd.Function`` whose forward keeps W, the Cholesky
factor and P for the backward, so one factorization serves both passes.

Edge mode (n > 4096 or ``solver='cg'``) is not ported yet.  The exploding-
gradient check is done on the host where a step's metrics are read
(:func:`warn_exploding_grad`), never inside the backward, so the backward
adds no host synchronization.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .dense_mode import DenseGraph, build_dense_graph, dense_backward, \
    dense_forward
from .solve import CholeskyFactor

__all__ = ["LaplaceConfig", "laplace_learning", "GRAD_NORM_WARN_THRESHOLD",
           "warn_exploding_grad"]

# The reference warns when ||dX||_F > 10 after the op's backward.  Set to
# 0/None to disable.
GRAD_NORM_WARN_THRESHOLD: float | None = 10.0

DENSE_MAX_N = 4096


class LaplaceConfig(NamedTuple):
    """Hyperparameters of the Laplace-learning op in dense mode (the
    Cholesky solver; edge mode and CG are not ported yet).

    tau:        diagonal regularizer added to Luu.  FullySup passes ``--temp``
                (0.07); the adversarial drivers use 0.
    epsilon:    'auto' for the self-tuning bandwidth (k-th NN distance) or a
                float.
    k:          neighbors per node, self included.
    use_kernel: 'auto', the only mode: K1 on CUDA tensors, its plain
                version on CPU tensors.
    """

    tau: float = 0.0
    epsilon: str | float = "auto"
    k: int = 25
    use_kernel: str = "auto"

    @property
    def auto_eps(self) -> bool:
        return isinstance(self.epsilon, str) and self.epsilon == "auto"


class _LaplaceDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, cfg: LaplaceConfig, stats: dict | None):
        g = build_dense_graph(x, cfg.k, cfg.epsilon)
        pred, (w, _, factor) = dense_forward(g, y, cfg.tau, x, cfg.use_kernel)
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
        gx = dense_backward(g, y, pred, x, CholeskyFactor(chol, info), gbar,
                            ctx.cfg.auto_eps, w=w)
        if ctx.stats is not None:
            ctx.stats["grad_norm"] = torch.linalg.vector_norm(gbar)
            ctx.stats["out_norm"] = torch.linalg.vector_norm(gx)
        return gx, None, None, None


def laplace_learning(x: torch.Tensor, y: torch.Tensor, tau: float = 0.0,
                     epsilon="auto", k: int = 25, solver: str = "cholesky",
                     mode: str = "auto", use_kernel: str = "auto",
                     stats: dict | None = None) -> torch.Tensor:
    """Functional entry point mirroring ``LaplaceLearningSparseHard.apply``.

    x: (n, d) features, first ``y.shape[0]`` rows labeled; y: (k_lab, l)
    one-hot labels.  Returns (n - k_lab, l) predictions for unlabeled rows.
    ``mode='auto'`` picks dense mode for n <= 4096 with the Cholesky solver,
    and edge mode otherwise.

    ``stats``: an optional dict the op fills with device scalars and never
    reads: ``chol_info`` (the forward's Cholesky info) and, after the
    backward, ``grad_norm`` (||dL/dP||) and ``out_norm`` (||dL/dX||).
    """
    if mode == "auto":
        mode = "dense" if (solver == "cholesky"
                           and x.shape[0] <= DENSE_MAX_N) else "edge"
    if mode == "edge":
        raise NotImplementedError(
            "edge mode (n > 4096 or solver='cg') is not ported yet; it is "
            "next in the queue (ROADMAP.md, section 1: ops/laplace.py edge "
            "mode and solver='cg', with the CG backward, over the ported "
            "ops/graph.py and stable_conjgrad)")
    if mode != "dense":
        raise ValueError(f"unknown mode {mode!r}")
    if solver != "cholesky":
        raise ValueError("mode='dense' requires solver='cholesky'")
    cfg = LaplaceConfig(float(tau), epsilon if isinstance(epsilon, str)
                        else float(epsilon), int(k), use_kernel)
    return _LaplaceDense.apply(x, y, cfg, stats)


def warn_exploding_grad(grad_norm: float, out_norm: float) -> bool:
    """Host-side exploding-gradient check on the norms a step reported.

    Prints the reference's message and returns True when ``out_norm``
    exceeds :data:`GRAD_NORM_WARN_THRESHOLD` (None or <= 0 disables)."""
    thresh = GRAD_NORM_WARN_THRESHOLD
    if not thresh or thresh <= 0 or not out_norm > thresh:
        return False
    print(f"possible exploding gradient\ngrad norm: {grad_norm}\n"
          f"out norm: {out_norm}")
    return True
