"""Cluster-banded exact KNN with a per-row certificate.

Twin of ``graphlearninglayer_tpu/ops/knn_banded.py``.  Between the evals of
one training run the features drift slowly, and the eval cache already
holds the last eval's cluster permutation (``EvalGraphCache.perm``).  Under
that permutation rows that lie close in feature space are contiguous, so
each row's nearest neighbors live in a few column blocks, and the selection
can run over a narrow band of them instead of all n columns:

  1. cut the permuted rows into ``nb`` blocks of ``block`` rows and compute
     each block's centroid and radius on the current features (so that
     correctness never depends on drift);
  2. for each row block, scan the ``band`` column blocks with the smallest
     lower bound (its own first): distances and top-k over
     ``band * block`` columns;
  3. certify each row with the ball bound
        d2(i, j in block b) >= max(0, ||x_i - c_b|| - r_b)^2:
     if the smallest bound over the unscanned blocks exceeds the row's k-th
     banded distance, no unscanned point can enter its list;
  4. rerun the rows left uncertified against all columns.

Every returned list is therefore exactly ``knn_tiled``'s: both passes
select by (d2, original node id) (``kernels.knn_topk.smallest_k``), the
rule of K2 and of ``knn_tiled``'s plain route, so a tie at the k-th slot
goes the same way whatever the permutation.  A poor permutation only
raises the fallback fraction.  The JAX package runs this outside Pallas,
and so does the port: matrix products and a top-k selection on either
device, no kernel.

Two differences from the JAX twin, neither of which changes a list:

  * the pad rows (far-away fill up to a multiple of ``block``) are left out
    of their block's centroid and radius, which they would otherwise
    inflate until that block never certifies anything; they lie so far
    from every real row that none of them can enter a real row's list;
  * the uncertified rows are rerun as they are, in panels of 2,048 rows,
    not padded to a power-of-two bucket: the bucket fixes a static shape
    for XLA's compile cache, which PyTorch does not have.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import pad_far_rows
from .kernels.knn_topk import smallest_k
from .precision import full_f32

__all__ = ["banded_knn"]

_FALLBACK_PANEL = 2048


def _pad_perm(perm: np.ndarray, n: int, n_pad: int) -> np.ndarray:
    """Extend a permutation of 0..n-1 with pad ids n..n_pad-1 at the end."""
    if len(perm) == n_pad:
        return perm
    return np.concatenate([np.asarray(perm, np.int64),
                           np.arange(n, n_pad, dtype=np.int64)])


def _banded_scan(x_p: torch.Tensor, n_real: int, k: int,
                 self_id: torch.Tensor, block: int, band: int):
    """The banded pass over the permuted rows ``x_p`` (the rows from
    ``n_real`` on are padding).

    Returns (nbr_p, dist2, certified): neighbor ids in permuted space,
    ascending squared distances (self pinned first, ties to the lower
    original id ``self_id``) and the per-row certificate."""
    n, d = x_p.shape
    nb = n // block
    xb = x_p.reshape(nb, block, d)
    real = (torch.arange(n, device=x_p.device) < n_real).reshape(nb, block)
    w = real.to(x_p.dtype)[:, :, None]
    centers = (xb * w).sum(dim=1) / w.sum(dim=1)             # (nb, d)
    spread = torch.sum((xb - centers[:, None, :]) ** 2, dim=-1)
    rad = torch.sqrt(torch.where(real, spread, 0.0).amax(dim=1))

    with full_f32():
        # each row's distance to every block center -> ball lower bounds
        xx = torch.sum(x_p * x_p, dim=-1)
        cc = torch.sum(centers * centers, dim=-1)
        dc = torch.sqrt((xx[:, None] + cc[None, :]
                         - 2.0 * (x_p @ centers.T)).clamp_min(0.0))
        lb2 = (dc - rad[None, :]).clamp_min(0.0) ** 2           # (n, nb)

        # the band of each row block: the column blocks with the smallest
        # within-block minimum lower bound, its own first
        s = lb2.reshape(nb, block, nb).amin(dim=1)              # (nb, nb)
        s = s.masked_fill(torch.eye(nb, dtype=torch.bool,
                                    device=x_p.device), -1.0)
        band_ids = torch.topk(s, band, dim=1, largest=False).indices

        col_base = torch.arange(block, device=x_p.device)
        blocks = torch.arange(nb, device=x_p.device)
        nbrs, dists, certs = [], [], []
        for q in range(nb):
            rows = q * block + col_base
            bids = band_ids[q]
            cols = (bids[:, None] * block + col_base[None, :]).reshape(-1)
            d2 = (xx[rows][:, None] + xx[cols][None, :]
                  - 2.0 * (xb[q] @ x_p[cols].T)).clamp_min(0.0)
            d2 = d2.masked_fill(self_id[rows][:, None]
                                == self_id[cols][None, :], -1.0)
            dist2, idx = smallest_k(d2, k, self_id[cols])
            # the certificate: the smallest lower bound over the blocks
            # outside the band, with the JAX twin's slack
            scanned = (blocks[None, :] == bids[:, None]).any(dim=0)
            m = lb2[rows].masked_fill(scanned[None, :], torch.inf).amin(1)
            t = dist2[:, k - 1]
            certs.append(m > t + 1e-3 * (1.0 + t))
            nbrs.append(cols[idx])
            dists.append(dist2.clamp_min(0.0))
    return torch.cat(nbrs), torch.cat(dists), torch.cat(certs)


def _fallback_rows(x_p: torch.Tensor, rows: torch.Tensor, k: int,
                   self_id: torch.Tensor):
    """Exact full-width KNN of the (permuted) row ids ``rows``, in panels of
    ``_FALLBACK_PANEL`` rows, ties to the lower original id ``self_id``."""
    n = x_p.shape[0]
    xx = torch.sum(x_p * x_p, dim=-1)
    cols = torch.arange(n, device=x_p.device)
    nbrs, dists = [], []
    with full_f32():
        for s in range(0, len(rows), _FALLBACK_PANEL):
            r = rows[s:s + _FALLBACK_PANEL]
            xq = x_p[r]
            d2 = (xx[r][:, None] + xx[None, :]
                  - 2.0 * (xq @ x_p.T)).clamp_min(0.0)
            d2 = d2.masked_fill(r[:, None] == cols[None, :], -1.0)
            dist2, idx = smallest_k(d2, k, self_id)
            nbrs.append(idx)
            dists.append(dist2.clamp_min(0.0))
    return torch.cat(nbrs), torch.cat(dists)


def banded_knn(x, k: int, perm, block: int = 512, band: int = 16,
               max_fallback_frac: float = 0.35):
    """Exact KNN of ``x`` (n, d) steered by a (possibly stale) permutation.

    The same ``(nbr, dist2)`` as :func:`ops.knn.knn_tiled` in the original
    row order (self first, ascending squared distances, ties to the lower
    node id), on ``x``'s device and in its dtype.  ``perm``: host ints
    that permute the rows into feature-space-coherent order, such as the
    last eval's cached BSR permutation.

    Returns ``(nbr, dist2, fallback_frac)``; ``fallback_frac`` is the share
    of rows the certificate sent to the full panel.  Above
    ``max_fallback_frac`` the banded pass has lost and ``(None, None,
    frac)`` comes back: the caller should run ``knn_tiled`` and refresh its
    permutation.
    """
    x = torch.as_tensor(x)
    n = x.shape[0]
    nbk = max(1, min(band, (n + block - 1) // block))
    pad = (-n) % block
    perm = np.asarray(perm, np.int64)
    if len(perm) != n:
        raise ValueError(f"perm has {len(perm)} entries for {n} rows")
    perm_p = _pad_perm(perm, n, n + pad)
    x = pad_far_rows(x, pad)
    perm_t = torch.as_tensor(perm_p, device=x.device)
    x_p = x[perm_t]
    # the original id of each permuted position: the self channel
    nbr_p, dist2, cert = _banded_scan(x_p, n, k, perm_t, block, nbk)
    cert[n:] = True                          # pad rows: don't care
    bad = torch.nonzero(~cert).squeeze(1)
    frac = len(bad) / n
    if frac > max_fallback_frac:
        return None, None, frac
    if len(bad):
        fb_nbr, fb_d2 = _fallback_rows(x_p, bad, k, perm_t)
        nbr_p[bad] = fb_nbr
        dist2[bad] = fb_d2

    # back to the original order: rows reordered by inv(perm), neighbor
    # ids mapped through perm
    inv = np.empty(len(perm_p), np.int64)
    inv[perm_p] = np.arange(len(perm_p))
    rows = torch.as_tensor(inv[:n], device=x.device)
    return perm_t[nbr_p][rows], dist2[rows], frac
