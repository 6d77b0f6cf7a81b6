"""Exact k-nearest-neighbor search in PyTorch.

Twin of ``graphlearninglayer_tpu/ops/knn.py``.  At the per-batch graph sizes
of the training op (n ~ 1.5k) exact KNN is one matrix product for the
distances plus one selection by (d2, index) (:func:`knn`).  At the transductive eval's
size (n ~ 60k, k = 50) :func:`knn_tiled` never forms the n x n matrix: for
k <= 64 it is kernel K2 on the card and K2's plain version on the CPU, for
larger k the blocked route of the JAX package's ``knn_tiled``.  Exact KNN is
deterministic, which the parity tests rely on.

Conventions (matching the reference):
  * Euclidean metric; ``dist2`` is the *squared* distance (the affinity only
    ever consumes d^2).  Every route ranks by |x_i|^2 + |x_j|^2 - 2 x_i.x_j
    and returns each kept edge's d^2 from the endpoints' difference
    (``kernels.knn_topk.kept_dist2``), so that equal rows are at exactly 0
    and their edge is dropped downstream, as in JAX's float64 Gram sums.
  * Self is always the first neighbor with distance 0.
  * Equal distances go to the lower index (``kernels.knn_topk.smallest_k``),
    as in K2 and the JAX package's ``lax.top_k`` routes, so coincident
    rows give the same lists on every route.
"""
from __future__ import annotations

import torch

from .kernels.knn_topk import (MAX_K, fused_knn, fused_knn_plain, kept_dist2,
                               smallest_k)

__all__ = ["pairwise_dist2", "knn", "knn_tiled"]


def pairwise_dist2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances between rows of ``x`` (n,d) and ``y`` (m,d).

    Uses the |x|^2 + |y|^2 - 2<x,y> expansion, so the dominant cost is one
    matrix product.  Clamped at zero to guard against negative round-off.
    """
    xx = torch.sum(x * x, dim=-1)
    yy = torch.sum(y * y, dim=-1)
    d2 = xx[:, None] + yy[None, :] - 2.0 * (x @ y.T)
    return d2.clamp_min(0.0)


def knn(x: torch.Tensor, k: int,
        d2: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN over all rows of ``x``; self included as neighbor 0.

    Returns ``(nbr, dist2)`` with shapes (n, k): ``nbr[i, 0] == i`` and the
    remaining columns are the k-1 nearest other points in ascending
    (distance, index) order of the Gram form ``d2``.  ``nbr`` is int64,
    PyTorch's index type.  ``dist2`` holds the kept edges' squared
    distances from the endpoints' difference (``dist2[:, 0] == 0``).

    ``d2``: optionally pass a precomputed (n, n) squared-distance matrix (the
    dense op path reuses one); it ranks, and is not returned.
    """
    n = x.shape[0]
    if d2 is None:
        d2 = pairwise_dist2(x, x)
    # pin self strictly first regardless of float noise or coincident points
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d2 = d2.masked_fill(eye, -1.0)
    idx = smallest_k(d2, k)[1]
    return idx, kept_dist2(x, x, idx)


def knn_tiled(x: torch.Tensor, k: int,
              block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Memory-bounded exact KNN for large n (the ~60k-node transductive
    path); same ``(nbr, dist2)`` contract as :func:`knn`, for any
    1 <= k <= n.

    The route is chosen from ``k`` alone, before anything is launched:

    * k <= 64 (``MAX_K``, the width of K2's lists): kernel K2,
      :func:`kernels.knn_topk.fused_knn`, with its contract (on the card a
      contiguous float32 ``x``).  On a CUDA tensor the kernel never writes a
      distance panel and ``block`` is unused; on a CPU tensor K2's plain
      version runs.
    * k > 64: the blocked route of the JAX package's ``knn_tiled``, on
      either device and in the input's dtype: per ``block`` query rows, one
      distance panel against all of ``x`` and one selection, self pinned
      first via d2 = -1 (:func:`kernels.knn_topk.fused_knn_plain`).  No
      kernel is launched, so ``fused_knn.launches`` does not move.

    Either way the peak panel memory of a blocked route is ``block`` x n.
    """
    if k <= MAX_K:
        return fused_knn(x, k, block)
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    if k > x.shape[0]:
        raise ValueError(f"k ({k}) exceeds the number of rows "
                         f"({x.shape[0]})")
    return fused_knn_plain(x, k, block)
