"""The port's exact KNN breaks ties by node index, as JAX's ``lax.top_k``
routes do, in float64 on the CPU.

The input has exact ties: 80 rows of 6 normal draws (seeds 0-5) with row
50 a copy of row 10 and rows 60 and 61 copies of row 30, so every other
row sees each copy at the same distance, and where a pair straddles a
row's k-th slot (k = 9) only the tie rule picks the neighbour.  The same
rows on a grid of 1/8 add ties between distinct rows, and there every d2
is exact in both frameworks.  On both:

* ``ops/knn.py::knn`` gives JAX ``knn(method='sort')``'s indices exactly
  and its distances within 1e-12 (exactly on the grid);
* ``fused_knn_plain`` (K2's plain version, below and above k = 64) gives
  JAX ``knn_tiled``'s;
* ``banded_knn``, with a band that scans every block and with one that
  sends most rows to its exact fallback, gives JAX ``knn_tiled``'s lists;
* ``build_graph(..., tiled=True)`` gives JAX's graph within 1e-12 on the
  grid, and on the normal draws at seeds 0, 2 and 3; at seeds 1, 4 and 5
  it does not (``_D2_RESIDUE``: a strict expected failure, the d2
  cancellation that ROADMAP.md keeps queued).

JAX's default dense ``knn`` selects with ``lax.approx_min_k``, whose order
among equal distances is its own: the op's parity against that default
stays undefined at exact ties, and it is not tested here.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.ops import graph as jgraph
from graphlearninglayer_tpu.ops.knn import knn as jknn
from graphlearninglayer_tpu.ops.knn import knn_tiled as jknn_tiled
from graphlearninglayer_tpu_torch.ops import graph as tgraph
from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import (
    SORT_COLS, fused_knn_plain, smallest_k)
from graphlearninglayer_tpu_torch.ops.knn_banded import banded_knn

# the module, which ``ops``' function ``knn`` shadows as an attribute
tknn = importlib.import_module("graphlearninglayer_tpu_torch.ops.knn")

N, D, K = 80, 6, 9
SEEDS = range(6)


def _coincident(seed: int, kind: str = "normal") -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.normal(size=(N, D))
    else:   # on a grid of 1/8: every d2 exact in any summation order
        x = rng.integers(-8, 9, size=(N, D)) / 8.0
    x[50] = x[10]
    x[60] = x[61] = x[30]
    return x


def _ties_at_the_boundary(x: np.ndarray, k: int) -> int:
    """Rows whose k-th and (k+1)-th squared distances (self first) are
    equal: where the tie rule alone picks the list."""
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, -1.0)
    s = np.sort(d2, axis=1)
    return int((s[:, k - 1] == s[:, k]).sum())


_jknn_sort = jax.jit(lambda x: jknn(x, K, method="sort"))


@jax.jit
def _jgraph(x):
    g = jgraph.build_graph(x, K, "auto", tiled=True, block=32)
    return g.nbr, g.dist2, g.coef, g.eps


@pytest.mark.parametrize("kind", ["normal", "grid"])
def test_input_has_ties_at_the_boundary(kind):
    """Across the seeds some rows' k-th slot is an exact tie, so the tests
    below see the tie rule decide a list."""
    assert sum(_ties_at_the_boundary(_coincident(s, kind), K)
               for s in SEEDS) > 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["normal", "grid"])
@pytest.mark.parametrize("route", ["knn", "plain_k9", "plain_k70",
                                   "banded_full", "banded_fallback"])
def test_exact_knn_breaks_ties_by_index(route, kind, seed):
    """The same indices exactly; the same distances within 1e-12 (the two
    frameworks sum the Gram products in other orders), and exactly on the
    grid."""
    x = _coincident(seed, kind)
    xt = torch.tensor(x)
    if route == "knn":
        want = _jknn_sort(jnp.asarray(x))
        got = tknn.knn(xt, K)
    elif route.startswith("plain"):
        k = int(route[len("plain_k"):])
        want = jknn_tiled(jnp.asarray(x), k, 32)
        got = fused_knn_plain(xt, k, 32)
    else:
        want = jknn_tiled(jnp.asarray(x), K, 32)
        perm = np.random.default_rng(100 + seed).permutation(N)
        band = 5 if route == "banded_full" else 1
        nbr, d2, frac = banded_knn(xt, K, perm, block=16, band=band,
                                   max_fallback_frac=1.0)
        assert (frac == 0.0) if band == 5 else (frac > 0.5)
        got = nbr, d2
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-12 if kind == "normal" else 0,
                               rtol=0)


# On the normal draws a coincident pair's float64 d2 is the cancellation
# residue of |x|^2 + |y|^2 - 2 x.y: 0 in JAX, up to 3.6e-15 in the port at
# seeds 1, 4 and 5, so JAX drops the pair's edge and the port keeps it.
# That d2 form, shared by the plain routes, K1 and K2, is queued in
# ROADMAP.md (section 2, the d2 cancellation; section 3, open faults).
_D2_RESIDUE = pytest.mark.xfail(
    strict=True, raises=AssertionError,
    reason="a coincident pair's d2 is 0 in JAX and a float64 residue in "
           "the port, which keeps the pair's edge (ROADMAP.md, d2 "
           "cancellation)")


@pytest.mark.parametrize("kind,seed", [
    pytest.param("grid", s, id=str(s)) for s in SEEDS] + [
    pytest.param("normal", s, id=f"normal-{s}",
                 marks=_D2_RESIDUE if s in (1, 4, 5) else ())
    for s in SEEDS])
def test_tiled_graph_on_coincident_rows_matches_jax(kind, seed):
    """The graph of the tiled lists, JAX's and the port's, within 1e-12.
    On the grid a coincident pair's d2 is 0 in both frameworks; on the
    normal draws see ``_D2_RESIDUE``."""
    x = _coincident(seed, kind)
    nbr, dist2, coef, eps = _jgraph(jnp.asarray(x))
    g = tgraph.build_graph(torch.tensor(x), K, "auto", tiled=True, block=32)
    np.testing.assert_array_equal(g.nbr.numpy(), np.asarray(nbr))
    for got, want in ((g.dist2, dist2), (g.coef, coef), (g.eps, eps)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-12, rtol=0)


@pytest.mark.parametrize("dtype,cols,values", [
    pytest.param(dtype, cols, values,
                 id=f"dtype{i}-{cols}" + ("" if values == 5 else "-2000"))
    for values in (5, 2000)
    for i, (dtype, cols) in enumerate([(torch.float32, 33),
                                       (torch.float64, 33),
                                       (torch.float32, 5000),
                                       (torch.float64, 5000)])])
def test_smallest_k_orders_by_value_then_id(dtype, cols, values):
    """Both of ``smallest_k``'s routes (a stable sort up to SORT_COLS
    columns, a repaired top-k above) against a lexicographic sort, on
    integer-valued rows full of ties (of ``values`` distinct values, so
    that at 2,000 the k-th value's ties fall both inside and outside the
    list), with self pinned at -1, a -0.0 and column ids that are not the
    positions."""
    assert (cols > SORT_COLS) == (cols == 5000)
    rng = np.random.default_rng(1)
    d2 = rng.integers(0, values, (40, cols)).astype(np.float64)
    d2[np.arange(33), np.arange(33)] = -1.0
    d2[0, 5] = -0.0
    ids = rng.permutation(cols)
    for col_ids in (None, ids):
        tie = np.arange(cols) if col_ids is None else col_ids
        want = np.stack([np.lexsort((tie, row))[:12] for row in d2])
        vals, pos = smallest_k(torch.tensor(d2, dtype=dtype), 12,
                               None if col_ids is None
                               else torch.tensor(col_ids))
        np.testing.assert_array_equal(pos.numpy(), want)
        np.testing.assert_array_equal(vals.numpy(),
                                      np.take_along_axis(d2, want, 1))
