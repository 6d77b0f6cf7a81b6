"""Kernel K2: exact fused KNN (all-pairs distance + running top-k).

``fused_knn(x, k)`` returns ``(nbr, dist2)``, both (n, k): for every row of
``x`` (n, d) its k nearest rows in ascending squared distance

    d2_ij = max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0),

self first (pinned by d2_ii := -1 during selection), ``nbr`` int64 and
``dist2`` clamped at 0.  ``rows=(r0, r1)`` returns the lists of the query
rows ``x[r0:r1]`` only, (r1 - r0, k), against all n rows, with self at its
global index: a rank's share of the sharded eval's build
(``parallel/edge_shard.py::sharded_knn``); each row's list equals the full
call's bit for bit.  It replaces the Pallas TPU kernel
``graphlearninglayer_tpu/ops/kernels/knn_topk.py::fused_knn`` and computes
what ``ops/knn.py::knn_tiled`` computes.

* On a CUDA tensor it launches the hand-written Hopper kernel in
  ``csrc/knn_topk.cu``, or raises.  There is no fallback.  It takes
  float32, contiguous, k <= 64.
* On a CPU tensor it runs :func:`fused_knn_plain`, the same function in
  plain PyTorch, in the input's dtype, ``block`` query rows at a time.

It replaces the TPU kernel's sequential grid and bitonic re-sort of a
running top-64 with a design for the H100.  The function is bound by
operations: one triangle of the Gram matrix, n (n + 1) / 2 d f32 FMA, 6.9 ms
at 67 TFLOP/s at the eval's shape (n = 60,250, d = 128, k = 50).  A
pre-kernel writes the norms and x transposed and padded for 16-byte copies;
a block keeps a panel of query rows resident in shared memory and streams
128-column candidate tiles through a ``cp.async`` double buffer into R x 4
register tiles, R rows a warp: whole waves of 128-row panels, then one
wave of smaller blocks for the rows left over, so the last wave spreads
over every SM.  After each tile a warp tests the rows it owns against
their k-th kept distance and queues only the survivors, which it merges
into the rows' sorted lists by (d2, index) 32 at a time.  On an H100 80GB
HBM3 at 700 W it takes 28.6 ms at the eval's shape, 24% of the bound and
1.55x faster than the previous design in the same call (``chip_smoke.py``,
``k2_turns.py``; ``PERF.md``).  It still forms both triangles, twice the
bound's operations, and each tile's selection sits between two block
barriers, where the FMA pipes wait for it.

``fused_knn.launches`` counts kernel launches; the plain version never moves
it.
"""
from __future__ import annotations

import ctypes

import torch

from ..precision import full_f32
from . import _build

__all__ = ["fused_knn", "fused_knn_plain", "smallest_k", "MAX_K"]

MAX_K = 64   # the running list's width (the Pallas kernel's default rt)
SORT_COLS = 4096    # widest row smallest_k selects from by a stable sort


def _rows(x: torch.Tensor, rows) -> tuple[int, int]:
    n = x.shape[0]
    r0, r1 = (0, n) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 < r1 <= n:
        raise ValueError(f"rows {rows} must satisfy 0 <= r0 < r1 <= {n}")
    return r0, r1


def smallest_k(d2: torch.Tensor, k: int, ids: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of ``d2`` (rows, cols), ascending
    by (value, column id): K2's order, and JAX ``lax.top_k``'s, so that of
    equal distances the lower id comes first.  ``ids`` (cols,) holds each
    column's id (default: its position).  Returns ``(values, positions)``,
    both (rows, k), the positions int64.

    Rows of up to ``SORT_COLS`` entries take a stable ``torch.sort`` of the
    row (on the card PyTorch sorts such rows in one block's shared memory);
    wider rows one ``torch.topk`` and a repair of its ties
    (:func:`select_by_topk`).  On an H100 80GB HBM3 the sort takes 0.22 ms
    and the repaired top-k 0.50 at 1,500 x 1,500, k = 25 (the train step's
    KNN); 1.72 and 0.81 at 2,048 x 8,192, k = 50; 11.0 and 3.0 at a 2,048 x
    60,250 panel of the eval's plain route, where a bare top-k takes 1.6
    (``chip_smoke.py``'s ``knn_select``, ``PERF.md``)."""
    cols = d2.shape[1]
    tie = (torch.arange(cols, device=d2.device) if ids is None
           else ids.to(torch.int64))
    select = select_by_sort if cols <= SORT_COLS else select_by_topk
    idx = select(d2, k, tie)
    return d2.gather(1, idx), idx


def select_by_sort(d2: torch.Tensor, k: int, tie: torch.Tensor
                   ) -> torch.Tensor:
    """:func:`smallest_k`'s positions by a stable sort of each row, its
    columns first put in ``tie`` order."""
    order = torch.argsort(tie)
    pos = torch.sort(d2[:, order], dim=1, stable=True).indices[:, :k]
    return order[pos]


def select_by_topk(d2: torch.Tensor, k: int, tie: torch.Tensor
                   ) -> torch.Tensor:
    """:func:`smallest_k`'s positions by one ``torch.topk`` of each row,
    whose order among equal values is open, then repaired: a row where
    more than k entries are at most its k-th kept value left out an entry
    that ties with it, and is selected again by :func:`select_by_sort`
    (one host sync decides whether any row is); then each row's k entries
    are put in (value, id) order."""
    vals, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    short = torch.nonzero((d2 <= vals[:, k - 1:]).sum(1) > k).squeeze(1)
    if len(short):
        idx[short] = select_by_sort(d2[short], k, tie)
        vals = d2.gather(1, idx)
    by_id = torch.argsort(tie[idx], dim=1)
    by_value = torch.sort(vals.gather(1, by_id), dim=1, stable=True).indices
    return idx.gather(1, by_id.gather(1, by_value))


def fused_knn_plain(x: torch.Tensor, k: int, block: int = 1024, rows=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 in plain PyTorch (the JAX package's ``knn_tiled`` route): per
    ``block`` query rows, one distance panel against all of ``x`` and one
    selection by (d2, index), :func:`smallest_k`.  Peak panel memory is
    ``block`` x n.  ``rows=(r0, r1)``: the query rows ``x[r0:r1]`` only.
    The CPU path, and the yardstick the kernel is held against on the
    card."""
    r0, r1 = _rows(x, rows)
    xx_all = torch.sum(x * x, dim=-1)
    nbrs, dists = [], []
    with full_f32():
        for start in range(r0, r1, block):
            xb = x[start:min(start + block, r1)]
            local = torch.arange(xb.shape[0], device=x.device)
            qq = torch.sum(xb * xb, dim=-1)
            d2 = (qq[:, None] + xx_all[None, :]
                  - 2.0 * (xb @ x.T)).clamp_min(0.0)
            d2[local, local + start] = -1.0
            dist, idx = smallest_k(d2, k)
            nbrs.append(idx)
            dists.append(dist.clamp_min(0.0))
    return torch.cat(nbrs), torch.cat(dists)


def _check(x: torch.Tensor, k: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_knn requires 1 <= k <= {MAX_K}, got {k}")
    if k > x.shape[0]:
        raise ValueError(f"k ({k}) exceeds the number of rows "
                         f"({x.shape[0]})")


_lib = None


def _kernel():
    """The library of ``csrc/knn_topk.cu``, its C entry points typed, built
    on first use."""
    global _lib
    if _lib is None:
        lib = _build.load("knn_topk")
        lib.gll_knn_topk_workspace.argtypes = [ctypes.c_int] * 3
        lib.gll_knn_topk_workspace.restype = ctypes.c_size_t
        lib.gll_knn_topk_f32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.gll_knn_topk_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(x: torch.Tensor, k: int, r0: int, r1: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    if x.dtype != torch.float32:
        raise TypeError(f"the K2 kernel takes float32; x is {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the K2 kernel takes a contiguous x")
    n, d = x.shape
    lib = _kernel()
    nbytes = lib.gll_knn_topk_workspace(n, d, k)
    if nbytes == 0:
        raise RuntimeError(f"the K2 kernel refuses n={n}, d={d}, k={k}")
    work = torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
    nbr = torch.empty((r1 - r0, k), dtype=torch.int64, device=x.device)
    dist2 = torch.empty((r1 - r0, k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gll_knn_topk_f32(x.data_ptr(), work.data_ptr(),
                                   nbr.data_ptr(), dist2.data_ptr(), n, d, k,
                                   r0, r1, stream)
    if err != 0:
        raise RuntimeError(f"K2 KNN kernel launch failed with CUDA error "
                           f"{err} (n={n}, d={d}, k={k}, rows {r0}:{r1})")
    fused_knn.launches += 1
    return nbr, dist2


def fused_knn(x: torch.Tensor, k: int, block: int = 1024, rows=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN ``(nbr, dist2)`` of the rows of ``x``, or of the query
    rows ``rows=(r0, r1)`` against all of them; see the module docstring.
    CUDA tensors go to the kernel, CPU tensors to the plain version, which
    alone uses ``block``."""
    _check(x, k)
    r0, r1 = _rows(x, rows)
    if x.device.type == "cpu":
        return fused_knn_plain(x, k, block, (r0, r1))
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, got {x.device}")
    return _launch(x, k, r0, r1)


fused_knn.launches = 0
