"""Transductive Laplace learning over large graphs (the eval path).

Twin of ``graphlearninglayer_tpu/ops/transductive.py``: build a k=50 KNN
graph over base + train + test features (~60k nodes for CIFAR-10) with
``knn_tiled`` (kernel K2 on the card for k <= 64), then solve the
label-propagation system with a Jacobi-preconditioned ``stable_conjgrad``.

Four matvec modes, the same as the JAX package's:

  * ``mode='bsr'`` (default): cluster-reorder the nodes, densify the
    symmetric matrix into dense tiles and run every CG matvec as a batched
    matrix product (ops/bsr.py).  Falls back to 'sorted' when the graph is
    small or has no block structure, or when the card runs out of memory.
  * ``mode='sorted'``: in-edges sorted by destination once per graph; every
    matvec is a gather plus a scatter-add over the sorted edge list.
  * ``mode='scatter'``: the simplest form, ``sym_spmm`` every iteration;
    kept as the numerics oracle.
  * ``mode='ell'``: the combined symmetric ELL(+COO) structure
    (ops/graph.py).

The CG loop checks its residual on the host once per iteration.  Set
``GLL_EVAL_DEBUG`` to anything but "0" for the planning printouts.

The trace (``utils/profiling.py``): spans ``eval.knn`` (the graph, K2),
``eval.plan`` (the BSR plan and its budgets) and ``eval.cg`` (the whole
Jacobi CG, its checks ``eval.cg.check`` inside); :data:`bsr_plans` counts
the BSR plans made, by route, and every read of a device result here is a
``host_sync``.

``GLL_BANDED_KNN=1`` (opt-in, as in the JAX package) builds the graph of a
cached eval of at least ``GLL_BANDED_MIN_N`` nodes (default 16,384) with the
certificate-banded KNN (ops/knn_banded.py), steered by the cache's last
permutation; when it cannot certify enough rows the eval falls back to
``knn_tiled`` and skips the banded pass for the next five evals.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import annotate, host_sync
from .bsr import (bsr_plan, bsr_plan_from_perm, bsr_spmm, bsr_stats,
                  build_bsr_mat)
from .graph import (build_graph, build_sym_ell, edge_weights, ell_cap,
                    ell_rowsum, ell_spmm, graph_from_knn, max_in_degree,
                    overflow_count, sym_rowsum, sym_spmm)
from .knn_banded import banded_knn
from .solve import stable_conjgrad

__all__ = ["one_hot_encode", "transductive_laplace", "EvalGraphCache",
           "bsr_plans"]

# BSR plans made, by route: 'from_perm' (tiles under the cache's
# permutation), 'fresh' (k-means, no permutation to reuse) and
# 'stale_replan' (k-means after the cached permutation proved stale)
bsr_plans = {"fresh": 0, "from_perm": 0, "stale_replan": 0}


def eval_debug() -> bool:
    """True when ``GLL_EVAL_DEBUG`` is set to anything but "0"."""
    return os.environ.get("GLL_EVAL_DEBUG", "0") not in ("", "0")


class EvalGraphCache:
    """Cross-eval amortization state for :func:`transductive_laplace`.

    Between eval epochs of one training run the features drift slowly, so
    these pieces are reusable:

      * ``perm``: last eval's cluster permutation; the BSR plan skips its
        k-means pass (``bsr_plan_from_perm``), and with
        ``GLL_BANDED_KNN=1`` it steers the banded KNN.  Exact for any
        permutation; an overflow-fraction check forces a fresh plan once it
        is stale.
      * ``smax`` / ``ovf_cap``: sticky tile and overflow budgets, reused as
        long as they still cover the new graph.
      * ``shard_perm`` / ``shard_nd``: the edge-sharded eval's cluster
        permutation (host int64, padded rows included) and the shard count
        it was made for (``parallel/edge_shard.py``); reusing it skips the
        k-means and chain ordering.
      * ``banded_skip``: after the banded KNN failed to certify, the count
        of evals that skip it before it is tried again.

    Unlike the JAX package's cache, this one keeps no CG warm start: every
    solve starts from zero.  The last eval's solution is a poor start once
    the base set has been refreshed (the driver refreshes it every epoch by
    default).  On a component of the graph that holds no labeled node the
    zero start is exact, while the old solution leaves residual components
    along eigenvalues near tau = 1e-8 that CG needs thousands of iterations
    to remove, and in float32 it can break down.  On an H100, with the
    warm start, the driver's evals of ResNet-18 features at 60,250 nodes
    after one and two epochs took 7,285 and 87,079 CG iterations, the
    second ending in NaN at chance accuracy (95 on the first, cold eval);
    tests/test_torch_transductive.py shows the effect on the CPU.

    A cache is valid for one problem shape; an (n, k_lab, l) mismatch
    ignores it.  Pass one instance across calls.
    """

    def __init__(self):
        self.clear()

    def clear(self):
        self.n = None
        self.k_lab = None
        self.perm = None          # device (n,) int64 (BSR plan)
        self.smax = None          # sticky slot budget
        self.ovf_cap = None       # sticky overflow budget
        self.shard_perm = None
        self.shard_nd = None
        self.banded_skip = 0

    def matches(self, n: int, k_lab: int) -> bool:
        return self.n == n and self.k_lab == k_lab


def one_hot_encode(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """One-hot float32 rows for integer labels."""
    return F.one_hot(torch.as_tensor(labels).long(), n_classes).float()


def _finish(result, tol: float = 1e-10, return_info: bool = False):
    """Unpack (pred, iters, err) from a solve and print the reference's CG
    non-convergence warning on the host.  ``return_info`` also returns
    (iters, err) as Python numbers."""
    pred, iters, err = result
    host_sync("transductive.finish")
    err = float(err)
    if err > tol:
        print(f"max iter reached:  {int(iters)}  iters")
    if return_info:
        return pred, int(iters), err
    return pred


def _build_with_cache(x, knn_num: int, epsilon, knn_block: int,
                      cache: EvalGraphCache | None, n: int, k_lab: int):
    """The KNN graph of the eval, through the banded KNN when
    ``GLL_BANDED_KNN=1``, the cache holds a permutation for this shape and
    the graph has at least ``GLL_BANDED_MIN_N`` nodes; else ``knn_tiled``.
    The same lists either way (up to ties)."""
    min_n = int(os.environ.get("GLL_BANDED_MIN_N", 16384))
    use_banded = (os.environ.get("GLL_BANDED_KNN", "0") == "1"
                  and cache is not None and cache.matches(n, k_lab)
                  and cache.perm is not None and n >= min_n)
    if use_banded and cache.banded_skip > 0:
        cache.banded_skip -= 1
        use_banded = False
    if use_banded:
        host_sync("transductive.banded_perm")
        perm = cache.perm.cpu().numpy().astype(np.int64)
        if len(perm) == n:
            nbr, dist2, frac = banded_knn(x, knn_num, perm, block=256,
                                          band=32)
            if nbr is not None:
                if eval_debug():
                    print(f"  [banded knn: fallback_frac={frac:.3f}]",
                          flush=True)
                return graph_from_knn(nbr, dist2, epsilon, dtype=x.dtype)
            # the certificate failed wholesale: skip the banded pass for a
            # few evals instead of paying for it every time
            cache.banded_skip = 5
            if eval_debug():
                print(f"  [banded knn: uncertifiable (frac={frac:.3f}), "
                      f"full build]", flush=True)
    return build_graph(x, knn_num, epsilon, tiled=True, block=knn_block)


def _jacobi_cg(matvec, deg, y, tau, k_lab):
    """Pred = M cg(M Luu M, M (W_ul Y)) on the unlabeled rows, with
    M = diag(Luu)^(-1/2).  Returns (pred, iters, final_err).  The span
    ``eval.cg``."""
    with annotate("eval.cg"):
        n = deg.shape[0]
        m = n - k_lab
        dt = torch.promote_types(deg.dtype, y.dtype)
        y = y.to(dt)
        y_full = torch.cat([y, y.new_zeros((m, y.shape[1]))])
        rhs = matvec(y_full)[k_lab:]                   # -Lul @ Y

        diag = deg[k_lab:] + tau
        mscale = (1.0 / torch.sqrt(diag + 1e-10))[:, None]

        def mv(p):
            p = mscale * p
            wp = matvec(F.pad(p, (0, 0, k_lab, 0)))[k_lab:]
            return mscale * (diag[:, None] * p - wp)

        z, iters, err = stable_conjgrad(mv, mscale * rhs, return_info=True)
        return mscale * z, iters, err


def _solve_ell(g, y, cap: int, ovf_cap: int, tau: float):
    w, _ = edge_weights(g)
    ell = build_sym_ell(g, w, cap, ovf_cap)
    return _jacobi_cg(lambda p: ell_spmm(ell, p), ell_rowsum(ell), y, tau,
                      y.shape[0])


def _solve_scatter(g, y, tau: float):
    w, _ = edge_weights(g)
    return _jacobi_cg(lambda p: sym_spmm(g, w, p), sym_rowsum(g, w), y, tau,
                      y.shape[0])


def _solve_sorted(g, y, tau: float):
    w, _ = edge_weights(g)
    n, k = g.nbr.shape
    coefw = g.coef * w
    # one stable sort of the in-edges by destination row, reused by every
    # matvec
    dst = g.nbr.reshape(-1)
    order = torch.sort(dst, stable=True).indices
    dst_s = dst[order]
    src_s = torch.arange(n, device=dst.device).repeat_interleave(k)[order]
    c_s = coefw.reshape(-1)[order]

    def matvec(p):
        p = p.to(torch.promote_types(p.dtype, coefw.dtype))
        out = torch.sum(coefw[:, :, None] * p[g.nbr], dim=1)
        return out.index_add_(0, dst_s, c_s[:, None] * p[src_s])

    return _jacobi_cg(matvec, sym_rowsum(g, w), y, tau, y.shape[0])


def _solve_bsr(plan, y, block: int, smax: int, ovf_cap: int, tau: float):
    gp = plan.gp
    k_lab = y.shape[0]
    w, _ = edge_weights(gp)
    mat = build_bsr_mat(plan, w, block, smax, ovf_cap)
    deg = sym_rowsum(gp, w)
    y_perm = y[plan.perm[:k_lab]]
    out, iters, err = _jacobi_cg(lambda p: bsr_spmm(mat, p, gp.n), deg,
                                 y_perm, tau, k_lab)
    # back to the original (unlabeled) row order
    return out[plan.inv[k_lab:] - k_lab], iters, err


def _transductive_bsr(x, g, y, tau: float, block: int, max_tile_bytes: int,
                      cache: EvalGraphCache | None = None):
    """Two-stage BSR path: plan (reorder + block discovery), then the
    dense-tile CG.

    ``g`` is the prebuilt KNN graph, shared with the 'sorted' fallback.  The
    slot budget ``smax`` keeps each block-row's densest tiles within
    ``max_tile_bytes``; leftover edges ride the COO overflow.  Returns None
    when the graph is small or hopeless (overflow above a quarter of the
    edges even at the budget cap): the caller falls back to 'sorted'.
    ``cache`` reuses the previous permutation and budgets."""
    n = x.shape[0]
    k_lab = y.shape[0]
    if n < 4 * block:
        return None
    r_blk = -(-n // block)
    budget = max_tile_bytes // (r_blk * block * block * x.element_size())
    if budget < 8:                                 # cannot honor the cap
        return None

    with annotate("eval.plan"):
        plan, smax, ovf_cap = _bsr_budgets(x, g, k_lab, block, budget,
                                           cache)
    if plan is None:                               # no block structure
        return None
    res = _solve_bsr(plan, y, block, smax, ovf_cap, float(tau))
    if cache is not None:
        cache.n, cache.k_lab = n, k_lab
        cache.perm = plan.perm
        cache.smax, cache.ovf_cap = smax, ovf_cap
    return res


def _bsr_budgets(x, g, k_lab: int, block: int, budget: int,
                 cache: EvalGraphCache | None):
    """The BSR plan (from the cache's permutation while it still tiles
    the graph, else afresh) and its slot and overflow budgets: ``(plan,
    smax, ovf_cap)``, or ``(None, None, None)`` when the graph has no
    block structure."""
    n = x.shape[0]
    cached_perm = (cache.perm if cache is not None
                   and cache.matches(n, k_lab) else None)
    dbg = print if eval_debug() else (lambda *a, **k: None)

    def make_plan(perm, route):
        bsr_plans[route] += 1
        if perm is not None:
            plan = bsr_plan_from_perm(g, perm, block)
        else:
            n_clusters = max(8, min(512, n // 1024))
            plan = bsr_plan(x, g, k_lab, n_clusters, block)
        host_sync("transductive.plan_stats")
        hist = bsr_stats(plan, block).cpu().numpy().astype(np.int64)
        dbg("  [bsr: stats done]", flush=True)
        return plan, np.cumsum(hist)

    def _coverage(cum):
        """(total, smax_min, ovf_at, capped): smallest slot budget covering
        99% of edges, overflow for any budget, and the headroomed,
        budget-capped smax the solve would use."""
        total = int(cum[-1])
        smax_min = int(np.searchsorted(cum, 0.99 * total) + 1)

        def ovf_at(s):
            return total - int(cum[min(s, len(cum)) - 1])

        def capped(s):
            s = -(-(s + max(s // 8, 4)) // 16) * 16
            return max(min(s, int(budget) // 8 * 8, len(cum)), 1)

        return total, smax_min, ovf_at, capped

    plan, cum = make_plan(cached_perm, "fresh" if cached_perm is None
                          else "from_perm")
    total, smax_min, ovf_at, capped = _coverage(cum)
    if (cached_perm is not None
            and ovf_at(capped(smax_min)) > 0.25 * total):
        # stale permutation: under the capped slot count the cached
        # ordering no longer tiles this graph; plan afresh once
        plan, cum = make_plan(None, "stale_replan")
        total, smax_min, ovf_at, capped = _coverage(cum)

    # sticky budgets, decided per component: reuse the cached slot count
    # while it still covers the requirement within the budget, and the
    # cached overflow budget while the new overflow fits in it
    smax_req = capped(smax_min)
    cache_ok = cache is not None and cache.matches(n, k_lab)
    if (cache_ok and cache.smax is not None
            and smax_req <= cache.smax <= int(budget) // 8 * 8
            and cache.smax <= len(cum)):
        smax = cache.smax
    else:
        smax = smax_req
    ovf = ovf_at(smax)
    if ovf > 0.25 * total:                         # no block structure
        return None, None, None
    if cache_ok and cache.ovf_cap is not None and ovf <= cache.ovf_cap:
        ovf_cap = cache.ovf_cap
    else:
        ovf_cap = 0 if ovf == 0 else \
            -(-(ovf + max(ovf // 4, 2048)) // 16384) * 16384
    dbg(f"  [bsr: solve smax={smax} ovf_cap={ovf_cap} "
        f"smax_min={smax_min} total={total}]",
        flush=True)
    return plan, smax, ovf_cap


def transductive_laplace(x, y, knn_num: int = 50, epsilon="auto",
                         tau: float = 1e-8, knn_block: int = 2048,
                         mode: str = "bsr", ell_cap_limit: int = 512,
                         bsr_block: int = 256,
                         bsr_max_tile_bytes: int = 4 << 30,
                         return_info: bool = False,
                         cache: EvalGraphCache | None = None):
    """Full-dataset Laplace learning; labeled rows are 0..k_lab-1.

    x: (n, d) features; y: (k_lab, l) one-hot labels, on the same device.
    Returns (n - k_lab, l) scores for the unlabeled rows: Luu + tau I with
    the Jacobi preconditioner M = diag^(-1/2) and
    ``Pred = M cg(M Luu M, -M Lul Y)``.

    ``return_info=True`` returns (pred, cg_iters, final_err).  ``cache``: an
    :class:`EvalGraphCache` shared across calls (permutation reuse, sticky
    budgets, the banded KNN's permutation) without changing the result.
    ``knn_block`` is the plain KNN route's panel height (CPU tensors only).
    ``mode='ell'`` runs its matvecs through kernel P3 on the card, which
    takes float32 only: float64 features on the card raise ``TypeError``
    there (on the CPU every dtype runs P3's plain version).
    """
    epsilon = epsilon if isinstance(epsilon, str) else float(epsilon)
    if mode not in ("bsr", "sorted", "scatter", "ell"):
        raise ValueError(f"unknown mode {mode!r}")
    n, k_lab = int(x.shape[0]), int(y.shape[0])

    def _done(res):
        if cache is not None:
            cache.n, cache.k_lab = n, k_lab
        return _finish(res, return_info=return_info)

    with annotate("eval.knn"):
        g = _build_with_cache(x, knn_num, epsilon, knn_block, cache, n,
                              k_lab)
    if mode == "bsr":
        # the tile budget depends on the data; if the tiles exceed device
        # memory, degrade to 'sorted' instead of ending a training run
        try:
            res = _transductive_bsr(x, g, y, float(tau), bsr_block,
                                    bsr_max_tile_bytes, cache)
        except torch.cuda.OutOfMemoryError as e:
            print(f"transductive bsr mode failed "
                  f"({str(e).splitlines()[0][:120]}); falling back to sorted")
            # drop the budgets the failed attempt committed, so that they
            # are not retried (and failed again) on every later eval
            if cache is not None:
                cache.perm = None
                cache.smax = None
                cache.ovf_cap = None
            res = None
        if res is not None:
            return _done(res)
        mode = "sorted"                            # graph too dense to tile
    if mode == "sorted":
        return _done(_solve_sorted(g, y, float(tau)))
    if mode == "scatter":
        return _finish(_solve_scatter(g, y, float(tau)),
                       return_info=return_info)
    # ELL width = bucketed max in-degree, bounded by ell_cap_limit; hub rows'
    # in-edges beyond it go to the COO overflow (bucketed too)
    host_sync("transductive.ell_width")
    cap = min(ell_cap(int(max_in_degree(g))), ell_cap_limit)
    host_sync("transductive.ell_overflow")
    ovf = int(overflow_count(g, cap))
    ovf_cap = 0 if ovf == 0 else -(-ovf // 4096) * 4096
    return _finish(_solve_ell(g, y, cap, ovf_cap, float(tau)),
                   return_info=return_info)
