"""One d2 rule for every kept edge of the port: sum_f (x_i,f - x_j,f)^2,
formed from the endpoints' difference, in float64 on the CPU.

The input is ``test_torch_knn_ties.py``'s: 80 rows of 6 normal draws
(seeds 0-5), row 50 a copy of row 10 and rows 60 and 61 copies of row 30,
k = 9.  A coincident pair's float64 Gram d2 |x|^2 + |y|^2 - 2 x.y is 0 in
JAX's summation order and a residue of up to 1.4e-14 in torch's, so
before the rule the port kept an edge of weight ~1 that JAX drops.  Here:

* the dense graph (``build_dense_graph`` + ``dense_affinity``, through
  K1's plain version and through ``g.d2``) against JAX's: W is 0 on every
  coincident pair, and W, eps and ``g.d2`` agree within 1e-12 wherever the
  two masks agree (JAX's dense KNN selects with ``lax.approx_min_k``,
  which orders exact ties its own way);
* the dense op (``laplace_learning``, dense mode) against JAX's, scores
  and the gradient with respect to x, on rows with one coincident pair and
  no tie at any row's k-th slot, with the (k+1)-th (the boundary) or with
  the (k-1)-th: the auto-eps gradient flows to the k-th neighbor, and of
  two coincident rows at the k-th slot ``approx_min_k`` may name either;
* every KNN route's returned d2 (``fused_knn_plain`` below and above
  k = 64 and over a row range, the dense ``knn``, ``banded_knn``) against
  numpy's difference form within 1e-15 relative, and exactly 0 on
  coincident pairs and on self.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.ops import dense_mode as jdm
from graphlearninglayer_tpu.ops import laplace_learning as jax_laplace
from graphlearninglayer_tpu_torch.ops import dense_mode as tdm
from graphlearninglayer_tpu_torch.ops import laplace_learning
from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import fused_knn_plain
from graphlearninglayer_tpu_torch.ops.knn_banded import banded_knn
from tests.test_torch_knn_ties import (D, K, N, SEEDS, _coincident,
                                       _ties_at_the_boundary)

# the module, which ``ops``' function ``knn`` shadows as an attribute
tknn = importlib.import_module("graphlearninglayer_tpu_torch.ops.knn")

# (row, its copy) of every coincident pair of ``_coincident``
PAIRS = ((10, 50), (30, 60), (30, 61), (60, 61))


@jax.jit
def _jax_dense(x):
    g = jdm.build_dense_graph(x, K)
    w, _ = jdm.dense_affinity(g)
    return w, g.eps, g.d2, g.mask


def _coincident_mask(n: int = N) -> np.ndarray:
    m = np.zeros((n, n), dtype=bool)
    for a, b in PAIRS:
        m[a, b] = m[b, a] = True
    return m


@pytest.mark.parametrize("seed", SEEDS)
def test_dense_graph_matches_jax_on_coincident_rows(seed):
    x = _coincident(seed)
    w_j, eps_j, d2_j, mask_j = (np.asarray(a)
                                for a in _jax_dense(jnp.asarray(x)))
    xt = torch.tensor(x)
    g = tdm.build_dense_graph(xt, K)
    w_kernel, _ = tdm.dense_affinity(g, xt)   # K1's plain version
    w_d2, _ = tdm.dense_affinity(g)           # from g.d2 and g.mask
    pair = _coincident_mask()
    mask_t = g.mask.numpy()
    assert bool(g.m_raw.numpy()[pair].any())  # the pairs are KNN edges
    assert not w_j[pair].any()
    both = mask_t == mask_j
    assert both.mean() > 0.99
    for w in (w_kernel, w_d2):
        w = w.numpy()
        assert not w[pair].any()
        np.testing.assert_allclose(w[both], w_j[both], atol=1e-12, rtol=0)
    np.testing.assert_allclose(g.eps.numpy(), eps_j, atol=1e-12, rtol=0)
    np.testing.assert_allclose(g.d2.numpy()[both], d2_j[both], atol=1e-12,
                               rtol=0)
    assert not g.d2.numpy()[pair].any()


def _one_pair(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    x[50] = x[10]
    return x


def _ties_at_the_kth(x: np.ndarray, k: int) -> int:
    """Rows whose k-th squared distance (self first) equals the (k-1)-th:
    two coincident rows, either of which may be named the k-th."""
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, -1.0)
    s = np.sort(d2, axis=1)
    return int((s[:, k - 2] == s[:, k - 1]).sum())


@pytest.mark.parametrize("seed", [16, 19, 20])
def test_dense_op_matches_jax_with_a_coincident_pair(seed):
    """Row 50, unlabeled, is a copy of row 10, labeled; no row's k-th
    slot is a tie, so both frameworks build the same graph and name the
    same k-th neighbors."""
    x = _one_pair(seed)
    assert _ties_at_the_boundary(x, K) == 0 and _ties_at_the_kth(x, K) == 0
    rng = np.random.default_rng(100 + seed)
    k_lab, l = 20, 4
    y = np.eye(l)[rng.integers(0, l, k_lab)]
    gbar = rng.normal(size=(N - k_lab, l))
    kw = dict(tau=0.07, epsilon="auto", k=K, mode="dense")

    def jax_loss(xj):
        return jnp.sum(jax_laplace(xj, jnp.asarray(y), **kw)
                       * jnp.asarray(gbar))

    want = np.asarray(jax.jit(
        lambda xj: jax_laplace(xj, jnp.asarray(y), **kw))(jnp.asarray(x)))
    want_gx = np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    pred = laplace_learning(xt, torch.tensor(y), **kw)
    (pred * torch.tensor(gbar)).sum().backward()
    np.testing.assert_allclose(pred.detach().numpy(), want, atol=1e-10,
                               rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, atol=1e-10, rtol=0)


def _routes(xt: torch.Tensor, route: str):
    """(first query row, nbr, dist2) of one KNN route on ``xt``."""
    if route == "plain_k9":
        return 0, *fused_knn_plain(xt, K, 32)
    if route == "plain_k70":
        return 0, *fused_knn_plain(xt, 70, 32)
    if route == "plain_rows":
        return 20, *fused_knn_plain(xt, K, 16, rows=(20, 65))
    if route == "knn":
        return 0, *tknn.knn(xt, K)
    perm = np.random.default_rng(7).permutation(N)
    nbr, d2, _ = banded_knn(xt, K, perm, block=16, band=2,
                            max_fallback_frac=1.0)
    return 0, nbr, d2


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("route", ["plain_k9", "plain_k70", "plain_rows",
                                   "knn", "banded"])
def test_kept_edges_d2_from_the_difference(route, seed):
    x = _coincident(seed)
    r0, nbr, d2 = _routes(torch.tensor(x), route)
    nbr, d2 = nbr.numpy(), d2.numpy()
    rows = r0 + np.arange(nbr.shape[0])
    want = ((x[rows][:, None, :] - x[nbr]) ** 2).sum(-1)
    np.testing.assert_allclose(d2, want, rtol=1e-15, atol=0)
    assert (nbr[:, 0] == rows).all() and not d2[:, 0].any()
    pair = _coincident_mask()[rows[:, None], nbr]
    assert pair.any() and not d2[pair].any()
