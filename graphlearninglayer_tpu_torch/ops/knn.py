"""Exact k-nearest-neighbor search in PyTorch.

Twin of ``graphlearninglayer_tpu/ops/knn.py``.  At the per-batch graph sizes
of the training op (n ~ 1.5k) exact KNN is one matrix product for the
distances plus one ``torch.topk`` (:func:`knn`).  At the transductive eval's
size (n ~ 60k, k = 50) :func:`knn_tiled` never forms the n x n matrix: on the
card it is kernel K2, on the CPU K2's plain version.  Exact KNN is
deterministic, which the parity tests rely on.

Conventions (matching the reference):
  * Euclidean metric; ``dist2`` is the *squared* distance (the affinity only
    ever consumes d^2).
  * Self is always the first neighbor with distance 0.
"""
from __future__ import annotations

import torch

from .kernels.knn_topk import fused_knn

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
    remaining columns are the k-1 nearest other points in ascending distance
    order.  ``nbr`` is int64, PyTorch's index type.  ``dist2`` holds squared
    distances (``dist2[:, 0] == 0``).

    ``d2``: optionally pass a precomputed (n, n) squared-distance matrix (the
    dense op path reuses one).
    """
    n = x.shape[0]
    if d2 is None:
        d2 = pairwise_dist2(x, x)
    # pin self strictly first regardless of float noise or coincident points
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d2 = d2.masked_fill(eye, -1.0)
    dist, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return idx, dist.clamp_min(0.0)


def knn_tiled(x: torch.Tensor, k: int,
              block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Memory-bounded exact KNN for large n (the ~60k-node transductive
    path); same ``(nbr, dist2)`` contract as :func:`knn`.

    It is kernel K2, :func:`kernels.knn_topk.fused_knn`, with its contract
    (``k`` at most 64; on the card a contiguous float32 ``x``).  On a CUDA
    tensor the kernel never writes a distance panel and ``block`` is unused.
    On a CPU tensor K2's plain version takes ``block`` query rows at a time,
    one distance panel against all of ``x`` and one ``torch.topk``, so the
    peak panel memory is ``block`` x n.
    """
    return fused_knn(x, k, block)
