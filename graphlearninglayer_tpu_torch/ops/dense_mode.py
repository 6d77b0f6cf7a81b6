"""Dense-mode graph Laplace learning: the per-batch fast path.

Twin of ``graphlearninglayer_tpu/ops/dense_mode.py``.  For per-batch graphs
(n up to a few thousand) the whole op is elementwise n x n math plus matrix
products:

  * union symmetrization = elementwise max of the directed KNN mask with its
    transpose;
  * the backward's edge product matrix
        G_ij = sum_c (w_c[i]-w_c[j])(F_c[j]-F_c[i])
    expands to  W_f + W_f^T - wf 1^T - 1 wf^T  with W_f = w @ F^T and
    wf_i = <w_i, F_i>;
  * Lap(A) X = deg_A * X - A @ X;
  * the auto-eps vector b is a masked elementwise product + row sum.

The affinity W comes from kernel K1 (``kernels/affinity.py``) on CUDA
tensors and from K1's plain version on CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import annotate
from .kernels.affinity import fused_affinity_sym
from .knn import knn, pairwise_dist2
from .solve import CholeskyFactor, cholesky_factor

__all__ = ["DenseGraph", "build_dense_graph", "dense_affinity",
           "dense_forward", "dense_backward"]


class DenseGraph(NamedTuple):
    """Dense symmetrized KNN graph over n nodes.

    m_raw: (n, n) {0,1} float: the RAW directed KNN indicator
           (m_raw[i, nbr[i, :]] = 1).  The union symmetrization and the
           self/zero-distance exclusions are applied lazily (``mask``) or
           inside kernel K1.
    d2:    (n, n) float: squared distances; on the KNN union's support
           (each (i, nbr[i]) and (nbr[i], i)) from the endpoints'
           difference, as every kept edge's d2 is, elsewhere the Gram
           form that ranked the neighbors.
    eps:   (n,) float: per-node bandwidth (k-th NN distance in auto mode).
    nbr:   (n, k) int64: KNN lists (kept for the auto-eps selector).
    """

    m_raw: torch.Tensor
    d2: torch.Tensor
    eps: torch.Tensor
    nbr: torch.Tensor

    @property
    def mask(self) -> torch.Tensor:
        """Final symmetrized edge mask (union of directed KNN edges; self
        and zero-distance entries dropped)."""
        n = self.m_raw.shape[0]
        mask = torch.maximum(self.m_raw, self.m_raw.T)
        off_diag = 1.0 - torch.eye(n, dtype=mask.dtype, device=mask.device)
        return mask * off_diag * (self.d2 > 0.0)

    @property
    def n(self) -> int:
        return self.m_raw.shape[0]

    @property
    def kth(self) -> torch.Tensor:
        return self.nbr[:, -1]


def build_dense_graph(x: torch.Tensor, k: int, epsilon="auto") -> DenseGraph:
    n = x.shape[0]
    d2 = pairwise_dist2(x, x)
    nbr, dist2 = knn(x, k, d2=d2)
    # the kept edges' d2, in both directions of the union, from the
    # endpoints' difference (knn's dist2): W, the zero-distance test and
    # the auto-eps backward read these, and a coincident pair is at 0
    rows = torch.arange(n, device=x.device)[:, None].expand_as(nbr)
    d2[rows, nbr] = dist2
    d2[nbr, rows] = dist2
    m_raw = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    m_raw.scatter_(1, nbr, 1.0)

    if isinstance(epsilon, str):
        if epsilon != "auto":
            raise ValueError(
                f"epsilon must be 'auto' or a float, got {epsilon!r}")
        # floored like the edge path, to keep the op total on degenerate
        # (collapsed-feature) inputs
        eps = torch.sqrt(dist2[:, -1]).clamp_min(1e-6)
    else:
        eps = torch.full((n,), float(epsilon), dtype=x.dtype, device=x.device)
    return DenseGraph(m_raw=m_raw, d2=d2, eps=eps, nbr=nbr)


def dense_affinity(g: DenseGraph, x: torch.Tensor | None = None,
                   use_kernel: str = "auto"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """W and V as dense masked matrices.

    ``use_kernel='auto'`` (the only mode) takes W from K1: the CUDA kernel in
    float32 for CUDA tensors, its plain version in the input dtype for CPU
    tensors.  On CPU tensors ``x=None`` forms W from ``g.d2`` and ``g.mask``
    instead; on any other device W needs ``x``, since K1 forms it.
    V is one elementwise op on W.
    """
    if use_kernel != "auto":
        raise ValueError(f"use_kernel must be 'auto', got {use_kernel!r}")
    inv = 1.0 / (g.eps[:, None] * g.eps[None, :])
    if x is not None:
        kdt = torch.float32 if x.is_cuda else x.dtype
        w = fused_affinity_sym(x.to(kdt).contiguous(), g.eps.to(kdt),
                               g.m_raw.to(kdt)).to(x.dtype)
    elif g.m_raw.device.type == "cpu":
        w = torch.exp(-4.0 * g.d2 * inv) * g.mask
    else:
        raise ValueError(f"dense_affinity on {g.m_raw.device} tensors takes W "
                         f"from kernel K1, which needs the features x")
    v = -8.0 * w * inv
    return w, v


def dense_forward(g: DenseGraph, y: torch.Tensor, tau: float,
                  x: torch.Tensor | None = None, use_kernel: str = "auto"):
    """Solve (Luu + tau I) P = W_ul Y with one Cholesky; returns
    ``(pred, (w, deg, factor))``.  Spans ``gl.op.affinity`` (K1) and
    ``gl.op.solve`` (the system, the factor and the solve)."""
    k_lab = y.shape[0]
    with annotate("gl.op.affinity"):
        w, _ = dense_affinity(g, x, use_kernel)
    with annotate("gl.op.solve"):
        deg = torch.sum(w, dim=1)
        luu = torch.diag(deg[k_lab:] + tau) - w[k_lab:, k_lab:]
        rhs = w[k_lab:, :k_lab] @ y
        factor = cholesky_factor(luu)
        pred = factor.solve(rhs)
    return pred, (w, deg, factor)


def dense_backward(g: DenseGraph, y: torch.Tensor, pred: torch.Tensor,
                   x: torch.Tensor, factor: CholeskyFactor,
                   gbar: torch.Tensor, auto_eps: bool,
                   w: torch.Tensor | None = None,
                   use_kernel: str = "auto") -> torch.Tensor:
    """Implicit-diff input gradient, all-matmul formulation.  Pass the
    forward's affinity ``w`` to reuse it (V is one elementwise op on W)."""
    k_lab = y.shape[0]
    wu = factor.solve(gbar)
    wfull = torch.cat([wu.new_zeros((k_lab, wu.shape[1])), wu])
    f = torch.cat([y.to(pred.dtype), pred])

    # G = W_f + W_f^T - wf 1^T - 1 wf^T on the edge mask
    wf_cross = wfull @ f.T
    wf_self = torch.sum(wfull * f, dim=1)
    g_mat = wf_cross + wf_cross.T - wf_self[:, None] - wf_self[None, :]

    if w is not None:
        inv = 1.0 / (g.eps[:, None] * g.eps[None, :])
        v = -8.0 * w * inv
    else:
        _, v = dense_affinity(g, x, use_kernel)
    a = g_mat * v  # v is zero off-edge, so masking is automatic
    # Lap(A) X = deg_A * X - A @ X
    deg_a = torch.sum(a, dim=1)
    gx = deg_a[:, None] * x - a @ x

    if auto_eps:
        # b_i = sum_j G_ij d2_ij V_ij / (2 eps_i^2)
        b = torch.sum(g_mat * g.d2 * v, dim=1) / (2.0 * g.eps * g.eps)
        kth = g.kth
        xd = x[kth] - x
        gx = gx + b[:, None] * xd
        gx.index_add_(0, kth, -b[:, None] * xd)
    return gx
