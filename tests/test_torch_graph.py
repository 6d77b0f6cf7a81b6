"""Port parity: ``ops/graph.py`` (the edge list, its weights and products,
and the ELL family) and ``ops/solve.py::stable_conjgrad`` against the JAX
package on the same float64 inputs.

Both sides do the same arithmetic in another summation order: 1e-12 for the
graph quantities, 1e-10 for the CG solution, and equal iteration counts.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.ops import graph as jg
from graphlearninglayer_tpu.ops import stable_conjgrad as jcg
from graphlearninglayer_tpu_torch.ops import graph as tg
from graphlearninglayer_tpu_torch.ops import stable_conjgrad as tcg
from tests.oracle.reference_op import build_affinity

ATOL = 1e-12


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_graph(x, vec, epsilon, tiled, block):
    """The JAX side of the graph test in one compiled program."""
    g = jg.build_graph(x, 8, epsilon, tiled=tiled, block=block)
    w, v = jg.edge_weights(g)
    return g, w, v, jg.sym_rowsum(g, w), jg.sym_spmm(g, w, vec), \
        jg.dense_weight_matrix(g, w)


@pytest.mark.parametrize("epsilon,tiled", [("auto", False), (1.5, True)])
def test_graph_weights_and_products_match_jax(rng, epsilon, tiled):
    x = rng.normal(size=(120, 10))
    vec = rng.normal(size=(120, 5))
    gj, wj, vj, deg_j, spmm_j, dense_j = _jax_graph(
        jnp.asarray(x), jnp.asarray(vec), epsilon, tiled, 50)
    gt = tg.build_graph(_t(x), 8, epsilon, tiled=tiled, block=50)
    np.testing.assert_array_equal(gt.nbr.numpy(), np.asarray(gj.nbr))
    np.testing.assert_array_equal(gt.kth.numpy(), np.asarray(gj.kth))
    for name in ("dist2", "coef", "eps"):
        _assert_close(getattr(gt, name), getattr(gj, name))
    assert (gt.n, gt.k) == (120, 8) and gt.coef.dtype == torch.float64

    wt, vt = tg.edge_weights(gt)
    _assert_close(wt, wj)
    _assert_close(vt, vj, atol=1e-9)
    _assert_close(tg.sym_rowsum(gt, wt), deg_j)
    _assert_close(tg.sym_spmm(gt, wt, _t(vec)), spmm_j)
    dense = tg.dense_weight_matrix(gt, wt)
    _assert_close(dense, dense_j)
    np.testing.assert_array_equal(dense.numpy(), dense.numpy().T)
    # and the scipy oracle's union-symmetrized W
    W, *_ = build_affinity(x, 8, epsilon)
    _assert_close(dense, W.toarray(), atol=1e-10)

    # graph_from_knn on the KNN lists gives the same graph
    g2 = tg.graph_from_knn(gt.nbr, gt.dist2, epsilon)
    for a, b in zip(g2, gt):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_zero_distance_edges_are_masked(rng):
    """A coincident pair: the zero-distance edges and the self edges carry
    no weight, and the exact-cap ELL product still equals sym_spmm."""
    x = rng.normal(size=(40, 4))
    x[7] = x[3]
    g = tg.build_graph(_t(x), 6)
    zero = (g.dist2 == 0.0) | (g.nbr == torch.arange(40)[:, None])
    assert zero.sum() == 40 + 2
    assert torch.all(g.coef[zero] == 0.0) and torch.all(g.coef[~zero] > 0.0)
    w, _ = tg.edge_weights(g)
    ell = tg.build_sym_ell(g, w, int(tg.max_in_degree(g)))
    vec = _t(rng.normal(size=(40, 3)))
    _assert_close(tg.ell_spmm(ell, vec), tg.sym_spmm(g, w, vec))


def _close_clusters(n_clusters, size, dim, spread, seed=0):
    """Float32 unit rows in tight clusters: ``size`` points a cluster,
    ``spread`` apart per coordinate, so that their squared distances lie
    far below float32's resolution of |x|^2 = 1."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, 1, dim))
    x = (centers + spread * rng.normal(size=(n_clusters, size, dim)))
    x = x.reshape(-1, dim)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def test_close_float32_pairs_keep_their_edges():
    """Clusters of float32 unit rows with d2 ~1e-11: the search's
    |x|^2 + |y|^2 - 2 x.y form, which the JAX graph keeps, zeroes some of
    those edges and drops them as coincident points; the port's edge
    distances come from the differences, so every non-self edge keeps a
    positive d2 and weight, within 1e-4 relative of the distances of the
    same float32 rows in float64."""
    x = _close_clusters(10, 4, 16, 1e-6)
    gj = jax.jit(lambda v: jg.build_graph(v, 4))(jnp.asarray(x))
    off_self = np.asarray(gj.nbr) != np.arange(40)[:, None]
    assert (np.asarray(gj.dist2)[off_self] == 0.0).sum() > 0

    gt = tg.build_graph(torch.from_numpy(x), 4)
    off_self = gt.nbr != torch.arange(40)[:, None]
    assert torch.all(gt.dist2[off_self] > 0.0)
    assert torch.all(gt.coef[off_self] > 0.0)
    assert torch.all(tg.edge_weights(gt)[0][off_self] > 0.0)
    x64 = torch.from_numpy(x).double()
    want = (x64[:, None, :] - x64[gt.nbr]).square().sum(-1)
    np.testing.assert_allclose(gt.dist2.double().numpy(), want.numpy(),
                               rtol=1e-4, atol=0)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_ell(x, vec, cap, ovf_cap):
    """The JAX side of the ELL test in one compiled program."""
    g = jg.build_graph(x, 8)
    w, v = jg.edge_weights(g)
    ell = jg.build_sym_ell(g, w, cap, ovf_cap)
    return (jg.max_in_degree(g), jg.overflow_count(g, cap), ell,
            jg.ell_rowsum(ell), jg.ell_spmm(ell, vec),
            jg.ell_reweight(g, ell, v).val)


@pytest.mark.parametrize("hub_split", [False, True])
def test_sym_ell_matches_jax(rng, hub_split):
    x = rng.normal(size=(120, 10))
    vec = rng.normal(size=(120, 5))
    gt = tg.build_graph(_t(x), 8)
    wt, vt = tg.edge_weights(gt)

    max_deg = int(tg.max_in_degree(gt))
    if hub_split:                  # hub edges beyond the cap go to the COO
        cap = max(1, max_deg // 2)
        ovf = int(tg.overflow_count(gt, cap))
        assert ovf > 0
        ovf_cap = ovf + 3
    else:
        cap, ovf_cap = tg.ell_cap(max_deg), 0
        assert cap == jg.ell_cap(max_deg) and cap >= max_deg
    deg_j, ovf_j, ej, rowsum_j, spmm_j, val_v_j = _jax_ell(
        jnp.asarray(x), jnp.asarray(vec), cap, ovf_cap)
    assert max_deg == int(deg_j)
    assert int(tg.overflow_count(gt, cap)) == int(ovf_j)
    et = tg.build_sym_ell(gt, wt, cap, ovf_cap)
    for name in ("nbr", "edge", "ovf_dst", "ovf_src", "ovf_edge"):
        np.testing.assert_array_equal(getattr(et, name).numpy(),
                                      np.asarray(getattr(ej, name)))
    _assert_close(et.val, ej.val)
    _assert_close(et.ovf_val, ej.ovf_val)

    _assert_close(tg.ell_rowsum(et), rowsum_j)
    _assert_close(tg.ell_spmm(et, _t(vec)), spmm_j)
    _assert_close(tg.ell_spmm(et, _t(vec)), tg.sym_spmm(gt, wt, _t(vec)))
    ev = tg.ell_reweight(gt, et, vt)
    _assert_close(ev.val, val_v_j, atol=1e-9)
    _assert_close(tg.ell_spmm(ev, _t(vec)), tg.sym_spmm(gt, vt, _t(vec)),
                  atol=1e-8)


def _spd(rng, m):
    a = rng.normal(size=(m, m))
    return a @ a.T + m * np.eye(m)


@pytest.mark.parametrize("zero_column", [False, True])
def test_stable_conjgrad_matches_jax(rng, zero_column):
    """Solution, iteration count and residual; with one RHS column exactly
    zero the masked alpha must keep that column at zero."""
    a = _spd(rng, 60)
    b = rng.normal(size=(60, 3))
    if zero_column:
        b[:, 1] = 0.0
    aj = jnp.asarray(a)
    xj, itj, errj = jcg(lambda p: aj @ p, jnp.asarray(b), return_info=True)
    at = _t(a)
    xt, itt, errt = tcg(lambda p: at @ p, _t(b), return_info=True)
    assert itt == int(itj)
    assert float(errt) <= 1e-10
    np.testing.assert_allclose(float(errt), float(errj), rtol=1e-3)
    _assert_close(xt, xj, atol=1e-10)
    np.testing.assert_allclose(xt.numpy(), np.linalg.solve(a, b), atol=1e-7)
    if zero_column:
        assert np.all(xt[:, 1].numpy() == 0.0)
    # a warm start at the solution needs no iteration; max_iter caps the loop
    assert tcg(lambda p: at @ p, _t(b), xt, return_info=True)[1] <= 1
    x2, it2, err2 = tcg(lambda p: at @ p, _t(b), max_iter=2,
                        return_info=True)
    assert it2 == 2 and float(err2) > 1e-10
