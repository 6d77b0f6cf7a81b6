"""Fixed-shape symmetrized KNN graph: the edge structures of the large-graph
solves.

Twin of ``graphlearninglayer_tpu/ops/graph.py``.  The graph keeps the
*directed* KNN edge list with fixed shape (n, k) plus a per-edge coefficient
that encodes the union-symmetrized graph:

  * with an exact KNN both directions of an edge carry the same distance,
    so the symmetrized matrix (elementwise max of Dist and Dist^T) is the
    union of the directed edges;
  * each directed edge gets ``coef = 1.0`` (one direction only) or ``0.5``
    (reciprocal pair), so that accumulating both endpoint contributions of
    every directed edge gives the symmetric matrix exactly;
  * self edges and zero-distance edges get ``coef = 0`` (the reference drops
    explicit zeros).  Every KNN route returns an edge's distance from the
    difference of its endpoints (``kernels.knn_topk.kept_dist2``), so that
    only equal rows count as coincident; the JAX package keeps the search's
    |x|^2 + |y|^2 - 2 x.y, which at float32 also zeroes close pairs.  The
    differences lose nothing to cancellation: at float32, unit rows whose
    d2 is below about 1e-7 (a barely trained encoder's features) would
    come out at 0 in the Gram form, leaving a node without edges and Luu
    singular at tau = 0.

Affinity values: W_ij = exp(-4 d_ij^2 / (eps_i eps_j)) and
V_ij = -8 W_ij / (eps_i eps_j), with eps_i the k-th-neighbor distance in
'auto' mode, floored at 1e-6 before use.

The ELL family holds the symmetrized matrix row by row (each row's k
out-edges plus its in-edges, padded to a slot budget, with a COO overflow
list for hub rows): one sort to build it, then every product is a gather
and a row sum, kernel P3 (``kernels/ell_spmm.py``) on the card.

Node indices are int64 (PyTorch's index type); the JAX package carries
int32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels.ell_spmm import ell_gather_spmm
from .knn import knn, knn_tiled

__all__ = [
    "BatchGraph",
    "build_graph",
    "graph_from_knn",
    "pad_far_rows",
    "edge_weights",
    "sym_rowsum",
    "sym_spmm",
    "dense_weight_matrix",
    "SymEll",
    "max_in_degree",
    "overflow_count",
    "ell_cap",
    "build_sym_ell",
    "ell_reweight",
    "ell_rowsum",
    "ell_spmm",
]

# rows per chunk of the reciprocal-edge test (a (chunk, k, k) gather)
_RECIP_CHUNK = 8192


class BatchGraph(NamedTuple):
    """Fixed-shape symmetrized KNN graph over n nodes with k directed edges
    per node.

    nbr:   (n, k) int64: ``nbr[i, 0] == i`` (self), then nearest neighbors.
    dist2: (n, k) float: squared euclidean distance along each edge.
    coef:  (n, k) float: symmetrization coefficient, 0.0 for masked edges
           (self / zero distance), 0.5 for reciprocal pairs, 1.0 otherwise.
    eps:   (n,) float: per-node kernel bandwidth.
    """

    nbr: torch.Tensor
    dist2: torch.Tensor
    coef: torch.Tensor
    eps: torch.Tensor

    @property
    def n(self) -> int:
        return self.nbr.shape[0]

    @property
    def k(self) -> int:
        return self.nbr.shape[1]

    @property
    def kth(self) -> torch.Tensor:
        """Index of each node's k-th nearest neighbor (last KNN column)."""
        return self.nbr[:, -1]


def build_graph(x: torch.Tensor, k: int, epsilon="auto", *,
                tiled: bool = False, block: int = 1024) -> BatchGraph:
    """The symmetrized KNN graph of the rows of ``x``.  ``tiled=True`` takes
    the memory-bounded :func:`knn_tiled` (kernel K2 on the card for
    k <= 64).

    ``epsilon``: 'auto' for the self-tuning bandwidth, else a positive
    float."""
    nbr, dist2 = knn_tiled(x, k, block) if tiled else knn(x, k)
    return graph_from_knn(nbr, dist2, epsilon, dtype=x.dtype)


def pad_far_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` (n, d) with ``pad`` rows appended far from every row and from
    each other (1e3 times the largest |entry| apart, and more): their
    affinities underflow to zero and none enters a real row's KNN list.
    The padding of the sharded evals and of the banded KNN."""
    if not pad:
        return x
    far = x.abs().max() * 1e3 + 1e3
    fill = far * (1.0 + torch.arange(pad, dtype=x.dtype,
                                     device=x.device)[:, None])
    return torch.cat([x, fill.expand(pad, x.shape[1])])


def graph_from_knn(nbr: torch.Tensor, dist2: torch.Tensor, epsilon="auto", *,
                   dtype=None) -> BatchGraph:
    """The post-KNN half of :func:`build_graph`: symmetrization coefficients
    and bandwidths from precomputed (nbr, dist2) lists."""
    n = nbr.shape[0]
    if dtype is None:
        dtype = dist2.dtype
    rows = torch.arange(n, device=nbr.device)

    # edge (i, j) is reciprocal iff i appears in j's neighbor list
    recip = torch.cat([
        (nbr[nbr[s:s + _RECIP_CHUNK]]
         == rows[s:s + _RECIP_CHUNK, None, None]).any(dim=-1)
        for s in range(0, n, _RECIP_CHUNK)])

    # drop self edges and exact-zero distances (coincident points)
    valid = (nbr != rows[:, None]) & (dist2 > 0.0)
    coef = torch.where(valid, torch.where(recip, 0.5, 1.0), 0.0).to(dtype)

    if isinstance(epsilon, str):
        if epsilon != "auto":
            raise ValueError(
                f"epsilon must be 'auto' or a float, got {epsilon!r}")
        # the k-th-neighbor distance, floored at 1e-6 before use so that a
        # node whose k-th neighbor is coincident gets no 0/0 affinity
        eps = torch.sqrt(dist2[:, -1]).clamp_min(1e-6)
    else:
        eps = torch.full((n,), float(epsilon), dtype=dtype, device=nbr.device)
    return BatchGraph(nbr=nbr, dist2=dist2, coef=coef, eps=eps)


def edge_weights(g: BatchGraph) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-directed-edge affinity W and derivative factor V, both (n, k)
    and symmetric in (i, j)."""
    inv = 1.0 / (g.eps[:, None] * g.eps[g.nbr])
    w = torch.exp(-4.0 * g.dist2 * inv)
    v = -8.0 * w * inv
    return w, v


def sym_rowsum(g: BatchGraph, vals: torch.Tensor) -> torch.Tensor:
    """Row sums (n,) of the symmetric matrix whose union-edge values are the
    (n, k) per-directed-edge ``vals``: the node degrees."""
    c = g.coef * vals
    out = torch.sum(c, dim=1)
    return out.index_add(0, g.nbr.reshape(-1), c.reshape(-1))


def sym_spmm(g: BatchGraph, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """A @ x for the symmetric edge-value matrix A (entries ``vals``) and a
    dense (n, l) ``x``: the out-edge half as a gather, the in-edge half as a
    scatter-add."""
    dt = torch.promote_types(vals.dtype, x.dtype)
    c = (g.coef * vals).to(dt)
    x = x.to(dt)
    out = torch.sum(c[:, :, None] * x[g.nbr], dim=1)
    contrib = (c[:, :, None] * x[:, None, :]).reshape(-1, x.shape[1])
    return out.index_add(0, g.nbr.reshape(-1), contrib)


def dense_weight_matrix(g: BatchGraph, vals: torch.Tensor) -> torch.Tensor:
    """The symmetric (n, n) matrix with union-edge values ``vals``."""
    n, k = g.nbr.shape
    c = (g.coef * vals).reshape(-1)
    rows = torch.arange(n, device=c.device).repeat_interleave(k)
    cols = g.nbr.reshape(-1)
    out = torch.zeros((n, n), dtype=vals.dtype, device=c.device)
    out.index_put_((rows, cols), c, accumulate=True)
    out.index_put_((cols, rows), c, accumulate=True)
    return out


class SymEll(NamedTuple):
    """Padded row-wise (ELL) form of the symmetric union-edge matrix, with a
    COO overflow list for hub nodes.

    nbr:  (n, S) int64: column of each slot (0 on padding slots).
    val:  (n, S) float: coefficient-folded symmetric value of the slot's
          edge (0 on padding slots).
    edge: (n, S) int64: flat directed-edge id in [0, n*k) of the slot's
          edge, n*k on padding slots (for :func:`ell_reweight`).
    ovf_dst/ovf_src/ovf_val/ovf_edge: (E_ovf,) overflow entries
          (A[dst, src] = val); dst == n and val == 0 on padding entries.
    cnt:  (n,) int32: each row's slots in use, k + min(in-degree, cap):
          its k out-edges (masked ones inside, at 0), then its in-edges,
          packed to the front; every slot past it is padding.
    """

    nbr: torch.Tensor
    val: torch.Tensor
    edge: torch.Tensor
    ovf_dst: torch.Tensor
    ovf_src: torch.Tensor
    ovf_val: torch.Tensor
    ovf_edge: torch.Tensor
    cnt: torch.Tensor


def _in_degrees(g: BatchGraph) -> torch.Tensor:
    valid = (g.coef.reshape(-1) > 0).long()
    return torch.zeros(g.n, dtype=torch.long, device=valid.device).index_add_(
        0, g.nbr.reshape(-1), valid)


def max_in_degree(g: BatchGraph) -> torch.Tensor:
    """Max over nodes of the number of valid incoming directed edges (a
    device scalar)."""
    return torch.max(_in_degrees(g))


def overflow_count(g: BatchGraph, cap: int) -> torch.Tensor:
    """Number of valid incoming edges beyond ``cap`` slots per row, in total
    (a device scalar)."""
    return torch.sum((_in_degrees(g) - cap).clamp_min(0))


def ell_cap(max_indeg: int, multiple: int = 32) -> int:
    """Slot budget for the in-edge half: ``max_indeg`` rounded up to
    ``multiple``, so that graphs of similar shape get the same layout."""
    m = max(int(max_indeg), 1)
    return -(-m // multiple) * multiple


def build_sym_ell(g: BatchGraph, vals: torch.Tensor, cap: int,
                  ovf_cap: int = 0) -> SymEll:
    """The combined ELL(+COO) structure for symmetric values ``vals``.

    Correct when the incoming edges beyond ``cap`` slots per row fit in
    ``ovf_cap`` (``ovf_cap >= overflow_count(g, cap)``; with
    ``cap >= max_in_degree(g)`` an ``ovf_cap`` of 0 suffices)."""
    n, k = g.nbr.shape
    dev = g.nbr.device
    e_cnt = n * k
    c = (g.coef * vals).reshape(-1)
    src = torch.arange(n, device=dev).repeat_interleave(k)
    dst = g.nbr.reshape(-1)
    # masked edges sort into a discarded bucket at row n
    dst_eff = torch.where(g.coef.reshape(-1) > 0, dst, n)
    order = torch.sort(dst_eff, stable=True).indices
    dst_s = dst_eff[order]
    src_s = src[order]
    c_s = c[order]
    # slot rank of each edge within its destination row
    rank = (torch.arange(e_cnt, device=dev)
            - torch.searchsorted(dst_s, dst_s, side="left"))
    row = torch.where((dst_s < n) & (rank < cap), dst_s, n)
    rank_c = rank.clamp_max(cap - 1)

    def scatter(fill, values):
        out = torch.full((n + 1, cap), fill, dtype=values.dtype, device=dev)
        return out.index_put_((row, rank_c), values)[:n]

    in_nbr = scatter(0, src_s)
    in_val = scatter(0, c_s)
    in_edge = scatter(e_cnt, order)
    # each row's in-slots in use, min(in-degree, cap), after its k out-slots
    in_used = torch.bincount(row, minlength=n + 1)[:n].to(torch.int32)

    if ovf_cap > 0:
        # pack the beyond-cap edges of hub rows to the front, keep ovf_cap
        over = (dst_s < n) & (rank >= cap)
        pos = torch.arange(e_cnt, device=dev)
        packed = torch.argsort(torch.where(over, pos, e_cnt + pos))[:ovf_cap]
        ok = over[packed]
        ovf_dst = torch.where(ok, dst_s[packed], n)
        ovf_src = torch.where(ok, src_s[packed], 0)
        ovf_val = torch.where(ok, c_s[packed], 0.0)
        ovf_edge = torch.where(ok, order[packed], e_cnt)
    else:
        ovf_dst = ovf_src = ovf_edge = torch.zeros(0, dtype=torch.long,
                                                   device=dev)
        ovf_val = torch.zeros(0, dtype=vals.dtype, device=dev)

    out_edge = torch.arange(e_cnt, device=dev).reshape(n, k)
    return SymEll(
        nbr=torch.cat([g.nbr, in_nbr], dim=1),
        val=torch.cat([g.coef * vals, in_val], dim=1),
        edge=torch.cat([out_edge, in_edge], dim=1),
        ovf_dst=ovf_dst, ovf_src=ovf_src, ovf_val=ovf_val, ovf_edge=ovf_edge,
        cnt=in_used + k,
    )


def ell_reweight(g: BatchGraph, ell: SymEll, vals: torch.Tensor) -> SymEll:
    """Same structure, new symmetric per-edge values (a gather)."""
    c = (g.coef * vals).reshape(-1)
    c_pad = torch.cat([c, c.new_zeros(1)])
    return ell._replace(val=c_pad[ell.edge], ovf_val=c_pad[ell.ovf_edge])


def _add_overflow(out: torch.Tensor, ell: SymEll,
                  contrib: torch.Tensor) -> torch.Tensor:
    # padding entries have dst == n: they land in a dropped extra row
    padded = torch.cat([out, out.new_zeros((1,) + out.shape[1:])])
    return padded.index_add_(0, ell.ovf_dst, contrib.to(out.dtype))[:-1]


def ell_rowsum(ell: SymEll) -> torch.Tensor:
    """Row sums (degrees) of the symmetric matrix, (n,)."""
    out = torch.sum(ell.val, dim=1)
    if ell.ovf_dst.shape[0]:
        out = _add_overflow(out, ell, ell.ovf_val)
    return out


def ell_spmm(ell: SymEll, x: torch.Tensor) -> torch.Tensor:
    """A @ x with A the symmetric ELL(+COO) matrix; x: (n, l) -> (n, l).
    The slots' sum is :func:`kernels.ell_spmm.ell_gather_spmm` (kernel P3
    on the card) over each row's ``cnt`` slots; hub edges beyond the slots
    are applied with one scatter-add."""
    dt = torch.promote_types(ell.val.dtype, x.dtype)
    x = x.to(dt).contiguous()
    out = ell_gather_spmm(ell.nbr, ell.val.to(dt), x, ell.cnt)
    if ell.ovf_dst.shape[0]:
        out = _add_overflow(out, ell, ell.ovf_val[:, None] * x[ell.ovf_src])
    return out
