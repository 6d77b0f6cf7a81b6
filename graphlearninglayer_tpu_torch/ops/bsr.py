"""Block-sparse (dense-tile) form of the symmetrized KNN matrix.

Twin of ``graphlearninglayer_tpu/ops/bsr.py``.  The large-graph CG matvec
trades random access for sequential dense reads:

  1. **Reorder** the nodes so that graph neighborhoods become index-local:
     a deterministic k-means over the features, clusters ranked along a
     greedy nearest-centroid chain, labeled nodes first.
  2. **Densify** the symmetric union-edge matrix into (B x B) tiles.  Each
     block-row keeps its ``smax`` densest tiles; the leftover edges (KNN
     hubs, the labeled block-row) go to a COO overflow list applied with
     one scatter-add per matvec.
  3. Every CG **matvec** is one batched matrix product over the tile lists,
     in full float32 (TF32 off inside the call: it would perturb CG's
     recursive residual).

Numerics equal ``sym_spmm``'s up to summation order.  When the data has no
cluster structure the overflow fraction explodes; :func:`bsr_stats` lets the
caller see that and fall back to the segment-sum path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import host_sync
from .graph import BatchGraph
from .precision import full_f32

__all__ = ["BsrPlan", "BsrMat", "kmeans", "kmeans_labels", "chain_rank",
           "bsr_plan", "bsr_plan_from_perm", "bsr_stats", "build_bsr_mat",
           "bsr_spmm", "bsr_tile_bytes"]


def kmeans(x: torch.Tensor, n_clusters: int, n_iter: int = 8):
    """Deterministic Lloyd k-means of the rows of ``x``.

    Returns ((n,) int64 labels, (C, d) centroids).  Init = evenly strided
    rows; empty clusters keep their previous centroid."""
    n = x.shape[0]
    stride = max(n // n_clusters, 1)
    cent = x[::stride][:n_clusters]
    ones = torch.ones((n,), dtype=x.dtype, device=x.device)

    def assign(cent):
        with full_f32():
            logits = x @ cent.T - 0.5 * torch.sum(cent * cent, dim=1)
        return torch.argmax(logits, dim=1)

    for _ in range(n_iter):
        a = assign(cent)
        sums = torch.zeros_like(cent).index_add_(0, a, x)
        cnt = torch.zeros((n_clusters,), dtype=x.dtype,
                          device=x.device).index_add_(0, a, ones)
        cent = torch.where(cnt[:, None] > 0,
                           sums / cnt.clamp_min(1.0)[:, None], cent)
    return assign(cent), cent


def kmeans_labels(x: torch.Tensor, n_clusters: int,
                  n_iter: int = 8) -> torch.Tensor:
    """Cluster labels only (see :func:`kmeans`)."""
    return kmeans(x, n_clusters, n_iter)[0]


def chain_rank(cent: torch.Tensor) -> torch.Tensor:
    """(C,) int64 rank of each cluster along a greedy nearest-neighbor chain
    over the centroids, starting at cluster 0: clusters with adjacent ranks
    are close in feature space.

    The centroid distances are formed on ``cent``'s device; the C - 1
    argmin steps of the chain run on the host (C <= 512)."""
    c = cent.shape[0]
    sq = torch.sum(cent * cent, dim=1)
    with full_f32():
        d2 = sq[:, None] + sq[None, :] - 2.0 * cent @ cent.T
    host_sync("bsr.chain_distances")
    d2 = d2.cpu()
    d2 = d2 + torch.where(torch.eye(c, dtype=torch.bool), torch.inf, 0.0)
    used = torch.zeros((c,), dtype=torch.bool)
    used[0] = True
    order = [0]
    for _ in range(c - 1):
        nxt = int(torch.argmin(torch.where(used, torch.inf, d2[order[-1]])))
        used[nxt] = True
        order.append(nxt)
    rank = torch.empty((c,), dtype=torch.long)
    rank[torch.tensor(order)] = torch.arange(c)
    host_sync("bsr.chain_rank")
    return rank.to(cent.device)


class BsrPlan(NamedTuple):
    """Artifacts of the reorder + block-discovery pass.

    gp:         the node-permuted graph (labeled rows first, then
                cluster-sorted unlabeled rows).
    perm, inv:  (n,) permutation old->slot and its inverse.
    slot_of:    (R*R + 1,) int64: for every tile key ``bi * R + bj``, the
                tile's rank within its block-row by edge count, densest
                first (empty tiles after all nonempty ones; the final
                sentinel entry maps masked edges out of range).
    tile_count: (R*R + 1,) int64: edges per tile.
    max_blocks: () int64: most nonzero block-columns of any block-row.
    """

    gp: BatchGraph
    perm: torch.Tensor
    inv: torch.Tensor
    slot_of: torch.Tensor
    tile_count: torch.Tensor
    max_blocks: torch.Tensor


class BsrMat(NamedTuple):
    """Densified symmetric matrix: per-block-row dense tiles + COO overflow.

    tiles:     (R, B, smax, B): tiles[r, i, s, j] = A[r*B+i, cols[r,s]*B+j].
    colblocks: (R, smax) int64: block-column of each slot; sentinel ``R``
               (a zero block of the iterate) on unused slots.
    ovf_dst/ovf_src/ovf_val: (E_ovf,) COO entries beyond the slot budget,
               sorted by dst; dst == n and val == 0 on padding entries.
    """

    tiles: torch.Tensor
    colblocks: torch.Tensor
    ovf_dst: torch.Tensor
    ovf_src: torch.Tensor
    ovf_val: torch.Tensor


def _both_orientations(gp: BatchGraph):
    """(rows, cols, ok) over both orientations of every directed edge."""
    n, k = gp.nbr.shape
    src = torch.arange(n, device=gp.nbr.device).repeat_interleave(k)
    dst = gp.nbr.reshape(-1)
    ok = gp.coef.reshape(-1) > 0
    return (torch.cat([src, dst]), torch.cat([dst, src]),
            torch.cat([ok, ok]))


def _finish_plan(g: BatchGraph, perm: torch.Tensor, block: int) -> BsrPlan:
    """Tile discovery for a given node permutation."""
    n, k = g.nbr.shape
    dev = g.nbr.device
    r_blk = -(-n // block)
    n_tiles = r_blk * r_blk
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=dev)
    gp = BatchGraph(nbr=inv[g.nbr[perm]], dist2=g.dist2[perm],
                    coef=g.coef[perm], eps=g.eps[perm])

    rows, cols, ok = _both_orientations(gp)
    key = torch.where(ok, (rows // block) * r_blk + cols // block, n_tiles)
    # a scatter-add of the valid edges, so that the sentinel bin stays 0:
    # on the card, bincount and a write of a Python 0 into the bin would
    # each make the host wait for the device
    tile_count = torch.zeros((n_tiles + 1,), dtype=torch.long,
                             device=dev).index_add_(0, key, ok.long())

    # densest-first rank of every tile within its block-row: a stable sort
    # by (block-row, -count) keeps ties in tile order (the JAX lexsort)
    trow = torch.arange(n_tiles, device=dev) // r_blk
    span = 2 * n * k + 1                       # > any tile's edge count
    order_t = torch.sort(trow * span + (span - 1 - tile_count[:n_tiles]),
                         stable=True).indices
    pos = torch.empty_like(order_t)
    pos[order_t] = torch.arange(n_tiles, device=dev)
    slot_of = torch.cat([pos - trow * r_blk,
                         torch.full((1,), r_blk, device=dev)])
    per_row = torch.zeros((r_blk,), dtype=torch.long, device=dev).index_add_(
        0, trow, (tile_count[:n_tiles] > 0).long())
    return BsrPlan(gp=gp, perm=perm, inv=inv, slot_of=slot_of,
                   tile_count=tile_count, max_blocks=torch.max(per_row))


def bsr_plan(x: torch.Tensor, g: BatchGraph, k_lab: int, n_clusters: int,
             block: int) -> BsrPlan:
    """Cluster-reorder the graph and discover its nonzero block structure.
    Nodes sort by the chained cluster rank, labeled nodes first."""
    n = g.nbr.shape[0]
    cluster, cent = kmeans(x, n_clusters)
    key = chain_rank(cent)[cluster]
    unlabeled = (torch.arange(n, device=x.device) >= k_lab).long()
    perm = torch.sort(key + n_clusters * unlabeled, stable=True).indices
    return _finish_plan(g, perm, block)


def bsr_plan_from_perm(g: BatchGraph, perm: torch.Tensor,
                       block: int) -> BsrPlan:
    """Tile discovery under a cached node permutation, which skips the
    k-means pass.  Exact for any permutation; only the overflow fraction
    grows as the permutation goes stale."""
    return _finish_plan(g, torch.as_tensor(perm, dtype=torch.long,
                                           device=g.nbr.device), block)


def bsr_stats(plan: BsrPlan, block: int) -> torch.Tensor:
    """(R,) histogram of valid edges per tile slot: ``hist[s]`` counts the
    symmetric-matrix entries in the s-th densest tile of their block-row, so
    the overflow of any slot budget ``smax`` is ``total - cumsum[smax-1]``."""
    n = plan.gp.nbr.shape[0]
    r_blk = -(-n // block)
    n_tiles = r_blk * r_blk
    hist = torch.zeros((r_blk + 1,), dtype=torch.long,
                       device=plan.tile_count.device)
    hist.index_add_(0, plan.slot_of[:n_tiles].clamp_max(r_blk),
                    plan.tile_count[:n_tiles])
    return hist[:r_blk]


def bsr_tile_bytes(n: int, block: int, smax: int, itemsize: int = 4) -> int:
    """Device bytes the densified tile array occupies."""
    r_blk = -(-n // block)
    return r_blk * block * smax * block * itemsize


def build_bsr_mat(plan: BsrPlan, vals: torch.Tensor, block: int, smax: int,
                  ovf_cap: int) -> BsrMat:
    """Densify symmetric union-edge values.

    vals: (n, k) per-directed-edge symmetric values (not coef-folded; the
    folding happens here, as in ``sym_spmm``).  Requires ``ovf_cap`` to be
    at least the overflow count from :func:`bsr_stats`: edges beyond both
    budgets would be dropped."""
    gp = plan.gp
    n = gp.nbr.shape[0]
    dev = gp.nbr.device
    r_blk = -(-n // block)
    n_tiles = r_blk * r_blk
    cw = (gp.coef * vals).reshape(-1)
    rows, cols, ok = _both_orientations(gp)
    v = torch.cat([cw, cw])
    key = torch.where(ok, (rows // block) * r_blk + cols // block, n_tiles)
    slot = plan.slot_of[key]                  # r_blk on masked edges
    in_cap = ok & (slot < smax)

    # edges outside the tiles (masked, or beyond the slot budget) go to one
    # extra element past the end, which is dropped
    size = r_blk * block * smax * block
    flat = (rows * smax + slot) * block + cols % block
    tiles = torch.zeros((size + 1,), dtype=vals.dtype, device=dev)
    tiles.index_add_(0, torch.where(in_cap, flat, size), v)
    tiles = tiles[:size].view(r_blk, block, smax, block)

    # one colblocks entry per nonempty tile within the budget
    tkey = torch.arange(n_tiles, device=dev)
    tslot = plan.slot_of[:n_tiles]
    keep = (plan.tile_count[:n_tiles] > 0) & (tslot < smax)
    colblocks = torch.full((r_blk * smax + 1,), r_blk, dtype=torch.long,
                           device=dev)
    colblocks[torch.where(keep, tkey // r_blk * smax + tslot,
                          r_blk * smax)] = tkey % r_blk
    colblocks = colblocks[:-1].view(r_blk, smax)

    if ovf_cap > 0:
        over = ok & ~in_cap
        # pack the overflow edges, then sort the packed list by row
        pos = torch.cumsum(over.long(), dim=0) - 1
        pos = torch.where(over & (pos < ovf_cap), pos, ovf_cap)

        def pack(fill, values):
            out = torch.full((ovf_cap + 1,), fill, dtype=values.dtype,
                             device=dev)
            return out.index_put_((pos,), values)[:ovf_cap]

        p_dst = pack(n, rows)
        p_src = pack(0, cols)
        p_val = pack(0, torch.where(over, v, 0.0))
        o = torch.sort(p_dst, stable=True).indices
        ovf_dst, ovf_src, ovf_val = p_dst[o], p_src[o], p_val[o]
    else:
        ovf_dst = ovf_src = torch.zeros((0,), dtype=torch.long, device=dev)
        ovf_val = torch.zeros((0,), dtype=vals.dtype, device=dev)
    return BsrMat(tiles=tiles, colblocks=colblocks, ovf_dst=ovf_dst,
                  ovf_src=ovf_src, ovf_val=ovf_val)


def bsr_spmm(mat: BsrMat, p: torch.Tensor, n: int) -> torch.Tensor:
    """A @ p over the tile structure; p: (n, l) -> (n, l).

    One block-granular gather of the iterate, then one batched
    (B, smax*B) x (smax*B, l) product per block-row, in full float32.
    Overflow edges are applied with one scatter-add."""
    r_blk, b, smax, _ = mat.tiles.shape
    l = p.shape[1]
    p = p.to(mat.tiles.dtype)
    xb = torch.cat([torch.nn.functional.pad(p, (0, 0, 0, r_blk * b - n))
                    .view(r_blk, b, l), p.new_zeros((1, b, l))])
    gathered = xb[mat.colblocks]                         # (R, smax, B, l)
    with full_f32():
        out = torch.bmm(mat.tiles.view(r_blk, b, smax * b),
                        gathered.view(r_blk, smax * b, l))   # (R, B, l)
    out = out.reshape(r_blk * b, l)[:n]
    if mat.ovf_dst.shape[0]:
        contrib = mat.ovf_val[:, None] * p[mat.ovf_src]
        out = out + torch.zeros((n + 1, l), dtype=out.dtype,
                                device=out.device).index_add_(
            0, mat.ovf_dst, contrib)[:n]
    return out
