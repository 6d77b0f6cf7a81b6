"""Port parity: kernel K2's plain version (``ops/kernels/knn_topk.py``) and
``ops/knn.py::knn_tiled`` against the JAX package.

* float64 against JAX ``knn_tiled``: the same arithmetic in another
  summation order, so identical neighbor lists and dist2 within 1e-9.
* float32 against the Pallas kernel ``fused_knn`` run in interpret mode
  (which computes in float32): identical neighbor sets and dist2 within
  1e-4, the distance between the JAX package's own two routes being ~2e-5.
* k > 64, beyond K2's lists: ``knn_tiled`` takes the blocked route, as JAX
  ``knn_tiled`` does for any k, with the f64 bar above; which route runs is
  decided by k alone.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.ops.kernels.knn_topk import fused_knn as jfused
from graphlearninglayer_tpu.ops.knn import knn_tiled as jknn_tiled
from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2
from graphlearninglayer_tpu_torch.ops.knn import knn_tiled

# the module, which ``ops``' function ``knn`` shadows as an attribute
tknn = importlib.import_module("graphlearninglayer_tpu_torch.ops.knn")


def _clustered(n, d, seed, l=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(l, d)) * 3.0
    x = centers[rng.integers(0, l, n)] + rng.normal(size=(n, d))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d,k,block", [(300, 16, 12, 64),
                                         (257, 9, 50, 1024),
                                         (130, 33, 1, 100)])
def test_knn_tiled_matches_jax_f64(n, d, k, block):
    x = _clustered(n, d, seed=n)
    nbr_j, d2_j = jknn_tiled(jnp.asarray(x), k, block)
    before = k2.fused_knn.launches
    for nbr_t, d2_t in (knn_tiled(torch.tensor(x), k, block),
                        k2.fused_knn_plain(torch.tensor(x), k, block),
                        k2.fused_knn(torch.tensor(x), k, block)):
        assert nbr_t.dtype == torch.int64 and d2_t.dtype == torch.float64
        np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
        np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j),
                                   atol=1e-9, rtol=0)
        assert np.all(nbr_t[:, 0].numpy() == np.arange(n))
        assert d2_t.min() >= 0.0
    # CPU tensors run the plain version: the kernel's count does not move
    assert k2.fused_knn.launches == before


def test_fused_knn_plain_matches_pallas_interpret_f32():
    n, d, k = 300, 32, 20
    x = _clustered(n, d, seed=7).astype(np.float32)
    nbr_j, d2_j = jfused(jnp.asarray(x), k, tq=128, tc=128, rt=32,
                         interpret=True)
    nbr_t, d2_t = k2.fused_knn_plain(torch.tensor(x), k, 128)
    assert d2_t.dtype == torch.float32
    np.testing.assert_array_equal(np.sort(nbr_t.numpy(), axis=1),
                                  np.sort(np.asarray(nbr_j), axis=1))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(nbr_t[:, 0].numpy(), np.arange(n))


def test_fused_knn_rejects_what_the_kernel_does_not_take():
    x = torch.tensor(_clustered(80, 4, seed=1))
    with pytest.raises(ValueError, match="k <= 64"):
        k2.fused_knn(x, 65)
    with pytest.raises(ValueError, match="k <= 64"):
        k2.fused_knn(x, 0)
    with pytest.raises(ValueError, match="exceeds the number of rows"):
        k2.fused_knn(x[:10], 11)
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        k2.fused_knn(x[0], 3)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k2.fused_knn(x.to("meta"), 3)


@pytest.mark.parametrize("k,block", [(65, 100), (100, 1024)])
def test_knn_tiled_above_k2_lists_matches_jax_f64(k, block):
    n, d = 257, 9
    x = _clustered(n, d, seed=k)
    nbr_j, d2_j = jknn_tiled(jnp.asarray(x), k, block)
    before = k2.fused_knn.launches
    nbr_t, d2_t = knn_tiled(torch.tensor(x), k, block)
    assert k2.fused_knn.launches == before
    assert nbr_t.dtype == torch.int64 and d2_t.dtype == torch.float64
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), atol=1e-9,
                               rtol=0)
    assert np.all(nbr_t[:, 0].numpy() == np.arange(n))


def test_knn_tiled_route_is_chosen_from_k(monkeypatch):
    """k <= 64 goes to K2's wrapper, k > 64 to the blocked route, and the
    refusals come before either; nothing runs (both routes are stubs)."""
    calls = []
    monkeypatch.setattr(tknn, "fused_knn",
                        lambda x, k, block: calls.append(("k2", k, block)))
    monkeypatch.setattr(tknn, "fused_knn_plain",
                        lambda x, k, block: calls.append(("blocked", k,
                                                          block)))
    x = torch.zeros((80, 4))
    knn_tiled(x, 64)
    knn_tiled(x, 65, 32)
    knn_tiled(x, 80)
    assert calls == [("k2", 64, 1024), ("blocked", 65, 32),
                     ("blocked", 80, 1024)]
    with pytest.raises(ValueError, match="exceeds the number of rows"):
        knn_tiled(x, 81)
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        knn_tiled(x[0], 65)
    assert len(calls) == 3
