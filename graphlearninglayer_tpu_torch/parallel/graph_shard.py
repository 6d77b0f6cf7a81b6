"""Row-partitioned eval: sharded ELL matvec and CG over the ranks.

Twin of ``graphlearninglayer_tpu/parallel/graph_shard.py``.  The symmetric
union-edge matrix is put in its combined ELL form (``ops/graph.py``
``build_sym_ell``: per row, all out- and in-edges as padded slot lists), and
its rows are cut into one contiguous block a rank, so a matvec is

    all-gather the (n / P, l) iterate  ->  (n, l) on every rank
    gather + slot-sum over the local rows (kernel P3 on the card)

and the CG (``stable_conjgrad``'s semantics, with masked per-column
updates) keeps every iterate sharded: its alpha / beta reductions are local
sums followed by all-reduces of (l,) values.  The graph itself is built on
every rank (``build_graph``, kernel K2 once a rank); the edge-partitioned
eval (``parallel/edge_shard.py``) shards the build too.
"""
from __future__ import annotations

import torch

from ..ops.graph import (BatchGraph, build_graph, build_sym_ell,
                         edge_weights, ell_cap, max_in_degree, pad_far_rows)
from ..ops.kernels.ell_spmm import ell_gather_spmm
from ..ops.solve import stable_conjgrad
from .mesh import Mesh

__all__ = ["sharded_laplace_solve", "sharded_transductive_laplace"]


def sharded_cg(mesh: Mesh, matvec, b: torch.Tensor, tol: float,
               max_iter: int):
    """``stable_conjgrad`` on this rank's rows ``b`` of a row-sharded
    system, from zero, its column sums all-reduced over the ranks.
    Returns (z, iters, final_err as a float)."""
    z, iters, err = stable_conjgrad(
        matvec, b, max_iter=max_iter, tol=tol, return_info=True,
        colsum=lambda v: mesh.all_reduce(torch.sum(v, dim=0)))
    return z, iters, float(err)


def sharded_laplace_solve(mesh: Mesh, g: BatchGraph, y: torch.Tensor,
                          tau: float, axis: str = "graph",
                          tol: float = 1e-10, max_iter: int = 10_000,
                          return_info: bool = False):
    """Solve (Luu + tau I) P = W_ul Y with the row-sharded ELL CG.

    ``g`` is the symmetrized KNN graph over all n nodes (labeled rows
    first) and ``y`` (k_lab, l), both on every rank.  Returns the (n - k_lab,
    l) predictions on every rank, the single-device Jacobi-preconditioned
    solve's (``ops/transductive.py``); ``return_info`` adds (iters,
    final_err).  n must be divisible by the axis size (pad upstream).
    """
    n = g.nbr.shape[0]
    k_lab, l = y.shape
    nd = mesh.axis_size(axis)
    if n % nd:
        raise ValueError(f"node count {n} not divisible by axis size {nd}")
    chunk = n // nd
    lo = mesh.rank * chunk

    w, _ = edge_weights(g)
    ell = build_sym_ell(g, w, ell_cap(int(max_in_degree(g))))
    nbr_loc = ell.nbr[lo:lo + chunk].contiguous()
    val_loc = ell.val[lo:lo + chunk].contiguous()
    dev, dt = val_loc.device, val_loc.dtype
    y_loc = torch.zeros((chunk, l), dtype=dt, device=dev)
    if lo < k_lab:
        y_loc[:min(chunk, k_lab - lo)] = y[lo:lo + chunk].to(dt)
    rows_loc = lo + torch.arange(chunk, device=dev)
    diag = torch.sum(val_loc, dim=1) + tau
    unlab = rows_loc >= k_lab
    mscale = torch.where(unlab, 1.0 / torch.sqrt(diag + 1e-10), 0.0)
    unlab = unlab.to(dt)[:, None]

    def spmm(x_loc):
        """This rank's rows of W @ x, from the all-gathered iterate."""
        return ell_gather_spmm(nbr_loc, val_loc,
                               mesh.all_gather(x_loc).contiguous())

    # rhs = M (W_ul Y): y is zero on unlabeled rows, M zero on labeled ones
    b = mscale[:, None] * spmm(y_loc)
    scaled_diag = (mscale * diag * mscale)[:, None]

    def matvec(p):
        """M Luu M on the unlabeled block, zero on labeled rows."""
        return scaled_diag * p - mscale[:, None] * spmm(mscale[:, None] * p) \
            * unlab

    z, iters, err = sharded_cg(mesh, matvec, b, tol, max_iter)
    pred = mesh.all_gather(mscale[:, None] * z)[k_lab:]
    return (pred, iters, err) if return_info else pred


def sharded_transductive_laplace(mesh: Mesh, x, y, knn_num: int = 50,
                                 epsilon="auto", tau: float = 1e-8,
                                 knn_block: int = 2048, axis: str = "graph",
                                 return_info: bool = False):
    """The mesh-sharded ``ops.transductive.transductive_laplace``: ``x``
    (n, d) and ``y`` (k_lab, l) on every rank, the (n - k_lab, l) scores on
    every rank.  The node count is padded to a multiple of the axis size
    with isolated dummy nodes, far from the data and from each other, whose
    affinities underflow to zero.  ``return_info`` adds (cg_iters,
    final_err), as the single-device eval's does."""
    x = torch.as_tensor(x).to(mesh.device)
    n = x.shape[0]
    x = pad_far_rows(x, (-n) % mesh.axis_size(axis))
    g = build_graph(x, knn_num, epsilon, tiled=True, block=knn_block)
    pred, iters, err = sharded_laplace_solve(
        mesh, g, torch.as_tensor(y).to(mesh.device), tau, axis,
        return_info=True)
    if err > 1e-10:
        print(f"max iter reached:  {iters}  iters")
    pred = pred[:n - y.shape[0]]
    return (pred, iters, err) if return_info else pred
