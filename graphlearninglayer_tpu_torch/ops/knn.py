"""Exact k-nearest-neighbor search in PyTorch.

Twin of ``graphlearninglayer_tpu/ops/knn.py`` (``pairwise_dist2``, ``knn``).
At the per-batch graph sizes of the training op (n ~ 1.5k) exact KNN is one
matrix product for the distances plus one ``torch.topk``.  Exact KNN is
deterministic, which the parity tests rely on.

Conventions (matching the reference):
  * Euclidean metric; ``dist2`` is the *squared* distance (the affinity only
    ever consumes d^2).
  * Self is always the first neighbor with distance 0.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_dist2", "knn"]


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
