"""Port parity: ``ops/transductive.py`` and ``ops/bsr.py`` against the JAX
package on clustered float64 graphs (n = 600, k = 12, 64-node BSR blocks).

Both sides do the same arithmetic in another summation order, so the bar is
max |pred difference| <= 1e-8, identical argmax and an equal CG iteration
count, in every matvec mode and with the cross-eval cache (which, unlike
the JAX package's, keeps no CG warm start: see ``EvalGraphCache``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearninglayer_tpu_torch.ops.transductive as tt
from graphlearninglayer_tpu.ops import EvalGraphCache as JCache
from graphlearninglayer_tpu.ops import transductive as jt
from graphlearninglayer_tpu_torch.ops import EvalGraphCache
from graphlearninglayer_tpu_torch.ops import bsr as tbsr
from graphlearninglayer_tpu_torch.ops import graph as tg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU ops are tiny: one thread runs them faster, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, L, K_LAB, KNN, BLOCK = 600, 5, 60, 12, 64


def _clustered(n=N, d=16, l=L, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(l, d)) * 3.0
    lab = rng.integers(0, l, n)
    x = centers[lab] + rng.normal(size=(n, d))
    return x / np.linalg.norm(x, axis=1, keepdims=True), lab


def _assert_same_solve(got, want):
    (pt, it_t, err_t), (pj, it_j, err_j) = got, want
    pj = np.asarray(pj)
    assert it_t == int(it_j)
    assert err_t <= 1e-10
    np.testing.assert_allclose(pt.numpy(), pj, atol=1e-8, rtol=0)
    np.testing.assert_array_equal(pt.numpy().argmax(1), pj.argmax(1))


@pytest.mark.parametrize("mode", ["bsr", "sorted", "scatter", "ell"])
def test_transductive_laplace_matches_jax(mode):
    x, lab = _clustered()
    y = np.eye(L)[lab[:K_LAB]]
    kw = dict(knn_num=KNN, mode=mode, bsr_block=BLOCK, return_info=True)
    jcache, cache = JCache(), EvalGraphCache()
    want = jt.transductive_laplace(jnp.asarray(x), jnp.asarray(y),
                                   cache=jcache, **kw)
    got = tt.transductive_laplace(torch.tensor(x), torch.tensor(y),
                                  cache=cache, **kw)
    _assert_same_solve(got, want)
    # bsr mode really tiled this graph (no fall-back to 'sorted'), with
    # the JAX package's node permutation and budgets
    assert (cache.perm is not None) == (mode == "bsr")
    assert cache.matches(N, K_LAB) == (mode in ("bsr", "sorted"))
    if mode == "bsr":
        np.testing.assert_array_equal(cache.perm.numpy(),
                                      np.asarray(jcache.perm))
        assert (cache.smax, cache.ovf_cap) == (jcache.smax, jcache.ovf_cap)
    acc = (got[0].numpy().argmax(1) == lab[K_LAB:]).mean()
    assert acc > 0.9


def test_transductive_laplace_k_above_k2_lists_matches_jax():
    """knn_num=65, past K2's 64-wide lists: the port's knn_tiled takes the
    blocked route (JAX's knn_tiled takes any k), with the bar above."""
    n = 300
    x, lab = _clustered(n=n, seed=5)
    y = np.eye(L)[lab[:K_LAB]]
    kw = dict(knn_num=65, mode="sorted", return_info=True)
    want = jt.transductive_laplace(jnp.asarray(x), jnp.asarray(y), **kw)
    got = tt.transductive_laplace(torch.tensor(x), torch.tensor(y), **kw)
    _assert_same_solve(got, want)
    assert (got[0].numpy().argmax(1) == lab[K_LAB:]).mean() > 0.9


def test_bsr_plan_and_product():
    """The plan permutes the graph without changing it, and the tile
    product equals sym_spmm, also with edges in the COO overflow."""
    x, _ = _clustered()
    g = tg.build_graph(torch.tensor(x), KNN)
    plan = tbsr.bsr_plan(torch.tensor(x), g, K_LAB, 8, BLOCK)
    perm = plan.perm.numpy()
    assert sorted(perm.tolist()) == list(range(N))
    np.testing.assert_array_equal(plan.inv.numpy()[perm], np.arange(N))
    assert set(perm[:K_LAB].tolist()) == set(range(K_LAB))
    w, _ = tg.edge_weights(g)
    wp, _ = tg.edge_weights(plan.gp)
    np.testing.assert_allclose(tg.sym_rowsum(plan.gp, wp).numpy(),
                               tg.sym_rowsum(g, w).numpy()[perm], atol=1e-12)
    np.testing.assert_array_equal(
        tbsr.bsr_plan_from_perm(g, plan.perm, BLOCK).slot_of.numpy(),
        plan.slot_of.numpy())
    hist = tbsr.bsr_stats(plan, BLOCK)
    assert int(hist.sum()) == 2 * int((g.coef > 0).sum())

    p = torch.tensor(np.random.default_rng(1).normal(size=(N, 5)))
    want = tg.sym_spmm(plan.gp, wp, p).numpy()
    smax = int(plan.max_blocks)
    for slots in (smax, smax + 3, smax // 2):
        ovf = int(hist[slots:].sum())
        assert (ovf > 0) == (slots < smax)
        mat = tbsr.build_bsr_mat(plan, wp, BLOCK, slots, -(-ovf // 64) * 64)
        assert mat.tiles.numel() * 8 == tbsr.bsr_tile_bytes(N, BLOCK, slots,
                                                            8)
        np.testing.assert_allclose(tbsr.bsr_spmm(mat, p, N).numpy(), want,
                                   atol=1e-12, rtol=0)


def test_eval_cache_warm_start_and_perm_reuse_match_jax(monkeypatch):
    """Two evals on slowly drifting features through one cache, on both
    sides: equal results, the k-means pass skipped on the second eval and
    the same sticky budgets and permutation.  The port's cache keeps no CG
    warm start, so its second solve takes a cold solve's iterations, not
    the JAX cache's warm count."""
    x1, lab = _clustered(seed=11)
    x2 = x1 + 0.02 * np.random.default_rng(12).normal(size=x1.shape)
    y = np.eye(L)[lab[:K_LAB]]
    kw = dict(knn_num=KNN, mode="bsr", bsr_block=BLOCK, return_info=True)

    fresh = []
    orig = tt.bsr_plan
    monkeypatch.setattr(tt, "bsr_plan",
                        lambda *a, **k: fresh.append(1) or orig(*a, **k))
    jcache, tcache = JCache(), EvalGraphCache()
    for i, x in enumerate((x1, x2)):
        want = jt.transductive_laplace(jnp.asarray(x), jnp.asarray(y),
                                       cache=jcache, **kw)
        got = tt.transductive_laplace(torch.tensor(x), torch.tensor(y),
                                      cache=tcache, **kw)
        if i == 0:
            _assert_same_solve(got, want)
        else:                                 # JAX warm, the port cold
            assert got[2] <= 1e-10 and want[1] < got[1]
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       atol=1e-8, rtol=0)
        assert (tcache.smax, tcache.ovf_cap) == (jcache.smax, jcache.ovf_cap)
        np.testing.assert_array_equal(tcache.perm.numpy(),
                                      np.asarray(jcache.perm))
    assert fresh == [1]                       # k-means skipped on eval 2
    cold = tt.transductive_laplace(torch.tensor(x2), torch.tensor(y), **kw)
    assert got[1] == cold[1]
    np.testing.assert_allclose(got[0].numpy(), cold[0].numpy(), atol=0)


@pytest.mark.parametrize("case", ["small_graph", "tile_budget",
                                  "out_of_memory"])
def test_bsr_falls_back_to_sorted(monkeypatch, capsys, case):
    x, lab = _clustered()
    y = torch.tensor(np.eye(L)[lab[:K_LAB]])
    x = torch.tensor(x)
    kw = dict(knn_num=KNN, return_info=True)
    want = tt.transductive_laplace(x, y, mode="sorted", **kw)
    block, tile_bytes = BLOCK, 4 << 30
    if case == "small_graph":                 # n < 4 * block
        block = 256
    elif case == "tile_budget":
        tile_bytes = 1
    else:
        def oom(*a, **k):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        monkeypatch.setattr(tt, "_transductive_bsr", oom)
    cache = EvalGraphCache()
    cache.perm, cache.smax, cache.ovf_cap = torch.arange(N), 64, 0
    got = tt.transductive_laplace(x, y, mode="bsr", bsr_block=block,
                                  bsr_max_tile_bytes=tile_bytes, cache=cache,
                                  **kw)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    assert got[1] == want[1]
    if case == "out_of_memory":
        assert "falling back to sorted" in capsys.readouterr().out
        assert (cache.perm, cache.smax, cache.ovf_cap) == (None, None, None)


def test_finish_warning_and_guards(monkeypatch, capsys):
    out = tt._finish((torch.ones(3, 2), 7, torch.tensor(1e-3)))
    assert out.shape == (3, 2)
    assert "max iter reached:  7  iters" in capsys.readouterr().out
    assert tt._finish((torch.ones(3, 2), 7, torch.tensor(1e-12,
                                                         dtype=torch.float64)),
                      return_info=True)[1:] == (7, 1e-12)
    assert "max iter" not in capsys.readouterr().out
    x = torch.tensor(_clustered(n=40)[0])
    y = tt.one_hot_encode(torch.tensor([0, 1, 2, 1]), 3)
    assert y.dtype == torch.float32 and y.sum() == 4
    with pytest.raises(ValueError, match="unknown mode"):
        tt.transductive_laplace(x, y, knn_num=5, mode="dense")
    # GLL_BANDED_KNN=1 without a cache builds the graph with knn_tiled
    want = tt.transductive_laplace(x, y, knn_num=5)
    monkeypatch.setenv("GLL_BANDED_KNN", "1")
    torch.testing.assert_close(tt.transductive_laplace(x, y, knn_num=5),
                               want, rtol=0, atol=0)
    for value, on in (("0", False), ("", False), ("1", True)):
        monkeypatch.setenv("GLL_EVAL_DEBUG", value)
        assert tt.eval_debug() is on
