"""The port's banded KNN (``ops/knn_banded.py``) against the JAX package's
``banded_knn`` in float64, the cases of tests/test_knn_banded.py at
n <= 600: the same lists (up to ties; random float64 rows have none) and
the same fallback fraction where n is a multiple of the block.  Where it
is not, the port leaves the far-away pad rows out of the last block's
centroid and radius, so its bounds are tighter: its fraction is at most
JAX's, and its lists are the same.  Then the ``GLL_BANDED_KNN=1`` eval
against JAX's, through a cache across three drifting evals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearninglayer_tpu_torch.ops.transductive as tt
from graphlearninglayer_tpu.ops import transductive as jtt
from graphlearninglayer_tpu.ops.knn_banded import banded_knn as jbanded
from graphlearninglayer_tpu_torch.ops.bsr import chain_rank, kmeans
from graphlearninglayer_tpu_torch.ops.knn import knn_tiled
from graphlearninglayer_tpu_torch.ops.knn_banded import banded_knn


def clustered(n, d=16, l=6, seed=0, spread=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(l, d)) * 4.0
    lab = rng.integers(0, l, n)
    return centers[lab] + spread * rng.normal(size=(n, d)), lab


def good_perm(x, n_clusters=16):
    """The permutation the eval cache holds: k-means + similarity chain."""
    labels, cent = kmeans(torch.as_tensor(x), n_clusters)
    return np.argsort(chain_rank(cent)[labels].numpy(), kind="stable")


def both(x, k, perm, **kw):
    got = banded_knn(torch.as_tensor(x), k, perm, **kw)
    want = jbanded(jnp.asarray(x), k, perm, **kw)
    return got, want


def same_lists(got, want):
    nbr, d2 = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(nbr, np.asarray(want[0]))
    np.testing.assert_allclose(d2, np.asarray(want[1]), atol=1e-12)


@pytest.mark.parametrize("n,k,block", [(512, 10, 64), (576, 25, 64)])
def test_banded_matches_jax_good_perm(n, k, block):
    x, _ = clustered(n, spread=0.5)
    got, want = both(x, k, good_perm(x), block=block, band=4)
    assert got[0] is not None, got[2]
    same_lists(got, want)
    assert got[2] == want[2] < 0.35
    nt, dt = knn_tiled(torch.as_tensor(x), k)
    np.testing.assert_array_equal(got[0].numpy(), nt.numpy())


def test_banded_exact_under_garbage_perm():
    x, _ = clustered(512, seed=3)
    perm = np.random.default_rng(3).permutation(512)
    got, want = both(x, 15, perm, block=64, band=2, max_fallback_frac=1.0)
    same_lists(got, want)
    assert got[2] == want[2] > 0.35


def test_banded_signals_hopeless_perm():
    x, _ = clustered(512, spread=4.0)
    perm = np.random.default_rng(4).permutation(512)
    got, want = both(x, 15, perm, block=64, band=2, max_fallback_frac=0.05)
    assert got[0] is None and got[1] is None and want[0] is None
    assert got[2] == want[2] > 0.05


def test_banded_nonmultiple_block_and_self_first():
    x, _ = clustered(600, d=8)
    got, want = both(x, 8, good_perm(x), block=128, band=2,
                     max_fallback_frac=1.0)
    nbr, d2 = got[0].numpy(), got[1].numpy()
    assert nbr.shape == (600, 8)
    np.testing.assert_array_equal(nbr[:, 0], np.arange(600))
    np.testing.assert_array_equal(d2[:, 0], 0.0)
    assert (np.diff(d2, axis=1) >= 0).all()
    same_lists(got, want)
    assert got[2] <= want[2]


def test_banded_drift_sequence_reuses_perm():
    x, _ = clustered(512, d=16, spread=0.5)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    perm = good_perm(x)
    rng = np.random.default_rng(7)
    for step in range(3):
        x = x + 0.02 * rng.normal(size=x.shape)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        got, want = both(x, 10, perm, block=64, band=4)
        assert got[0] is not None, f"step {step}: frac={got[2]}"
        same_lists(got, want)
        assert got[2] == want[2]


def test_transductive_banded_cache_path_matches_jax(monkeypatch):
    """Three cached evals on drifting features with ``GLL_BANDED_KNN=1``:
    from the second on the graph is built by the banded KNN, and the
    predictions equal JAX's (whose cache also warm-starts its CG; both
    solve to a residual of 1e-10) and the uncached port solve's."""
    monkeypatch.setenv("GLL_BANDED_KNN", "1")
    monkeypatch.setenv("GLL_BANDED_MIN_N", "500")
    calls = []
    monkeypatch.setattr(tt, "banded_knn",
                        lambda *a, **kw: calls.append(1) or banded_knn(
                            *a, **kw))
    x, lab = clustered(600, d=16, l=6, seed=1, spread=0.5)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.eye(6)[lab[:60]]
    rng = np.random.default_rng(5)
    cache, jcache = tt.EvalGraphCache(), jtt.EvalGraphCache()
    kw = dict(knn_num=10, bsr_block=64)
    for step in range(3):
        got = tt.transductive_laplace(torch.as_tensor(x), torch.as_tensor(y),
                                      cache=cache, **kw)
        want = jtt.transductive_laplace(jnp.asarray(x), jnp.asarray(y),
                                        cache=jcache, **kw)
        plain = tt.transductive_laplace(torch.as_tensor(x),
                                        torch.as_tensor(y), **kw)
        assert len(calls) == step
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-7)
        x = x + 0.02 * rng.normal(size=x.shape)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    assert cache.perm is not None and cache.banded_skip == 0
