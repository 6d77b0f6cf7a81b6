"""Graph Laplace learning, in plain PyTorch.

The layer of Calder et al.'s GraphLearningLayer (the reference's
``LaplaceLearningSparseHard``): features X (n, d), the first k_lab rows
labeled by one-hot Y (k_lab, l).

1. Exact k-nearest neighbours of every row over all rows, self first,
   ranked by squared euclidean distance with ties to the lower index.
2. Auto bandwidth eps_i = the distance to row i's k-th neighbour.
3. W_ij = exp(-4 d2_ij / (eps_i eps_j)) on the union of the directed KNN
   edges, with self and zero-distance pairs dropped; d2 of a kept edge is
   |x_i - x_j|^2 from the difference.
4. L = D - W; solve (L_uu + tau I) P = W_ul Y; P are the unlabeled rows'
   class scores.

The training layer's backward is autograd through these steps with the
neighbour selection held fixed: through the edges' d2, the bandwidths and
the dense solve, which is the implicit-differentiation gradient.  The eval
works on the (n, k) edge lists of a large graph and solves by CG with the
Jacobi preconditioner, in float64 (or, for the control, with its products
in TF32).
"""
from __future__ import annotations

import torch


def knn_select(x: torch.Tensor, k: int, block: int = 2048) -> torch.Tensor:
    """(n, k) lists of every row's k nearest rows, self first, ranked by the
    float64 Gram form |x_i|^2 + |x_j|^2 - 2 x_i.x_j with ties to the lower
    index.  Blocks of ``block`` query rows keep memory bounded."""
    x64 = x.detach().double()
    sq = torch.sum(x64 * x64, dim=1)
    n = x64.shape[0]
    out = []
    for s in range(0, n, block):
        q = x64[s:s + block]
        g = sq[s:s + block, None] + sq[None, :] - 2.0 * (q @ x64.T)
        rows = torch.arange(len(q), device=x.device)
        g[rows, rows + s] = -1.0                      # self first
        cand = torch.topk(g, min(k + 16, n), dim=1, largest=False).indices
        cand = torch.sort(cand, dim=1).values         # by index, then ...
        order = torch.sort(torch.gather(g, 1, cand), dim=1,
                           stable=True).indices       # ... by d2, stably
        out.append(torch.gather(cand, 1, order)[:, :k])
    return torch.cat(out)


def knn_lists(x: torch.Tensor, k: int):
    """(nbr, d2): :func:`knn_select`'s lists and each edge's float64 d2."""
    nbr = knn_select(x, k)
    return nbr, edge_d2(x.detach().double(), nbr)


def edge_d2(x: torch.Tensor, nbr: torch.Tensor,
            block: int = 8192) -> torch.Tensor:
    """|x_i - x_nbr[i, j]|^2 for every listed edge, in x's dtype (so that it
    carries x's gradient), in blocks of rows."""
    parts = []
    for s in range(0, x.shape[0], block):
        diff = x[s:s + block, None, :] - x[nbr[s:s + block]]
        parts.append(torch.sum(diff * diff, dim=-1))
    return torch.cat(parts)


def dense_predict(x: torch.Tensor, y: torch.Tensor, nbr: torch.Tensor,
                  tau: float) -> torch.Tensor:
    """The training layer's class scores P (n - k_lab, l) of features
    ``x`` (n, d) over the (n, k) neighbour lists ``nbr`` (held fixed),
    differentiable in ``x``; computes in x's dtype."""
    return torch.linalg.solve(*dense_system(x, y, nbr, tau))


def dense_system(x: torch.Tensor, y: torch.Tensor, nbr: torch.Tensor,
                 tau: float):
    """(L_uu + tau I, W_ul Y) of :func:`dense_predict`'s solve."""
    n = x.shape[0]
    k_lab = y.shape[0]
    d2e = edge_d2(x, nbr)
    eps = torch.sqrt(d2e[:, -1]).clamp_min(1e-6)
    rows = torch.arange(n, device=x.device)[:, None].expand_as(nbr)
    flat = (rows.reshape(-1), nbr.reshape(-1))
    directed = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    directed = directed.index_put(flat, d2e.reshape(-1))
    listed = torch.zeros((n, n), dtype=torch.bool, device=x.device)
    listed[flat] = True
    # a union edge's d2 from whichever direction listed it (equal when both)
    d2 = torch.where(listed, directed, directed.T)
    keep = ((listed | listed.T) & (d2 > 0)
            & ~torch.eye(n, dtype=torch.bool, device=x.device))
    w = torch.where(keep, torch.exp(-4.0 * d2 / (eps[:, None] * eps[None, :])),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    deg = torch.sum(w, dim=1)
    luu = torch.diag(deg[k_lab:] + tau) - w[k_lab:, k_lab:]
    rhs = w[k_lab:, :k_lab] @ y.to(x.dtype)
    return luu, rhs


def ce_loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The GL training loss: -sum(onehot * log(scores + 1e-8)) / B on the
    scores as they are (no softmax)."""
    picked = torch.gather(scores, 1, labels.long()[:, None])
    return -torch.sum(torch.log(picked + 1e-8)) / scores.shape[0]


def edge_weights(nbr: torch.Tensor, d2: torch.Tensor):
    """Symmetric float64 sparse W (n, n) of the eval graph from its (n, k)
    lists: the union of the directed edges, self and zero-distance pairs
    dropped, each kept edge exp(-4 d2 / (eps_i eps_j))."""
    n, k = nbr.shape
    d2 = d2.double()
    eps = torch.sqrt(d2[:, -1]).clamp_min(1e-6)
    rows = torch.arange(n, device=nbr.device)[:, None].expand(n, k)
    keep = (nbr != rows) & (d2 > 0)
    r, c, v = rows[keep], nbr[keep], d2[keep]
    val = torch.exp(-4.0 * v / (eps[r] * eps[c]))
    # union: both directions, a pair listed twice counted once
    ri = torch.cat([r, c])
    ci = torch.cat([c, r])
    vi = torch.cat([val, val])
    key = ri * n + ci
    key, first = _unique_first(key)
    return torch.sparse_coo_tensor(torch.stack([ri[first], ci[first]]),
                                   vi[first], (n, n),
                                   check_invariants=False).coalesce()


def _unique_first(key: torch.Tensor):
    """Sorted unique keys and, for each, the position of one occurrence."""
    order = torch.argsort(key, stable=True)
    sk = key[order]
    head = torch.ones_like(sk, dtype=torch.bool)
    head[1:] = sk[1:] != sk[:-1]
    return sk[head], order[head]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 rounded to TF32's 10 mantissa bits (to nearest,
    ties away from zero), as a tensor core takes a float32 operand."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def eval_scores(nbr: torch.Tensor, d2: torch.Tensor, y: torch.Tensor,
                tau: float, tol: float = 1e-13, max_iter: int = 100_000,
                prec: str = "float64") -> torch.Tensor:
    """The eval's class scores of the unlabeled rows, (n - k_lab, l): solve
    (L_uu + tau I) P = W_ul Y by CG on M (L_uu + tau I) M with the Jacobi
    M = diag(L_uu + tau I)^(-1/2).

    ``prec`` 'float64': in float64, to a relative residual of ``tol`` in
    every column.  'tf32': in float32 with every product by W taking its
    operands rounded to TF32 (a tensor core's float32 product), each
    column stopping once its residual is under ``tol``, as the program's
    CG stops; ``max_iter`` bounds it."""
    k_lab = y.shape[0]
    w = edge_weights(nbr, d2)
    deg = torch.sparse.sum(w, dim=1).to_dense()
    idx, val = w.indices(), w.values()
    if prec == "tf32":
        dt, rnd, val = torch.float32, tf32, tf32(val)
    elif prec == "float64":
        dt, rnd = torch.float64, (lambda v: v)
    else:
        raise ValueError(f"unknown precision {prec!r}")
    deg = deg.to(dt)
    uu = (idx[0] >= k_lab) & (idx[1] >= k_lab)
    ul = (idx[0] >= k_lab) & (idx[1] < k_lab)
    m = nbr.shape[0] - k_lab
    w_uu = torch.sparse_coo_tensor(idx[:, uu] - k_lab, val[uu], (m, m),
                                   check_invariants=False).coalesce()
    rhs = torch.sparse_coo_tensor(
        torch.stack([idx[0, ul] - k_lab, idx[1, ul]]), val[ul],
        (m, k_lab), check_invariants=False) @ rnd(y.to(dt))
    diag = deg[k_lab:] + tau
    msc = 1.0 / torch.sqrt(diag)
    tiny = torch.finfo(dt).tiny

    def op(v):
        u = msc[:, None] * v
        return msc[:, None] * (diag[:, None] * u - w_uu @ rnd(u))

    b = msc[:, None] * rhs
    z = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = torch.sum(r * r, dim=0)
    if prec == "tf32":
        stop = torch.full_like(rs, tol)
    else:
        stop = tol * torch.sqrt(torch.sum(b * b, dim=0)).clamp_min(tiny)
    for _ in range(max_iter):
        live = torch.sqrt(rs) > stop
        if not bool(torch.any(live)):
            break
        ap = op(p)
        alpha = torch.where(live, rs / torch.sum(p * ap, dim=0)
                            .clamp_min(tiny), 0.0)
        z = z + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r, dim=0)
        p = r + torch.where(live, rs_new / rs.clamp_min(tiny), 0.0) * p
        rs = rs_new
    return msc[:, None] * z
