"""Port parity: ``ops/knn.py`` and ``ops/dense_mode.py`` of the PyTorch port
against the JAX package on the same float64 inputs.

The point is the algorithm, so everything runs in float64 and must agree to
1e-12: both sides do the same arithmetic, in a different summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.ops import dense_mode as jdm
from graphlearninglayer_tpu.ops.knn import knn as jknn
from graphlearninglayer_tpu.ops.knn import pairwise_dist2 as jpairwise
from graphlearninglayer_tpu_torch.ops import dense_mode as tdm
from graphlearninglayer_tpu_torch.ops.knn import knn as tknn
from graphlearninglayer_tpu_torch.ops.knn import pairwise_dist2 as tpairwise
from tests.oracle import reference_op as ref


ATOL = 1e-12


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def test_pairwise_dist2_and_knn(rng):
    x = rng.normal(size=(120, 7))
    y = rng.normal(size=(50, 7))
    np.testing.assert_allclose(
        tpairwise(_t(x), _t(y)).numpy(),
        np.asarray(jpairwise(jnp.asarray(x), jnp.asarray(y))),
        atol=ATOL)
    for k in (1, 9, 25):
        nbr_j, d2_j = jknn(jnp.asarray(x), k)
        nbr_t, d2_t = tknn(_t(x), k)
        np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
        np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), atol=ATOL)
        assert np.all(nbr_t[:, 0].numpy() == np.arange(120))


@pytest.mark.parametrize("epsilon", ["auto", 1.3])
def test_dense_graph_and_affinity(rng, epsilon):
    x = rng.normal(size=(150, 9))
    gj = jdm.build_dense_graph(jnp.asarray(x), 11, epsilon)
    gt = tdm.build_dense_graph(_t(x), 11, epsilon)

    np.testing.assert_array_equal(gt.nbr.numpy(), np.asarray(gj.nbr))
    np.testing.assert_array_equal(gt.kth.numpy(), np.asarray(gj.kth))
    np.testing.assert_array_equal(gt.m_raw.numpy(), np.asarray(gj.m_raw))
    np.testing.assert_array_equal(gt.mask.numpy(), np.asarray(gj.mask))
    np.testing.assert_allclose(gt.d2.numpy(), np.asarray(gj.d2), atol=ATOL)
    np.testing.assert_allclose(gt.eps.numpy(), np.asarray(gj.eps), atol=ATOL)
    assert gt.n == 150

    w_j, v_j = jdm.dense_affinity(gj)
    # through K1's plain version (the CPU path of use_kernel='auto') and
    # through the distance-matrix formulation (x=None, CPU tensors only)
    for w_t, v_t in (tdm.dense_affinity(gt, _t(x)),
                     tdm.dense_affinity(gt)):
        assert w_t.dtype == torch.float64
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=ATOL)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=ATOL)


def test_dense_graph_matches_oracle_affinity(rng):
    """The port's W equals the scipy oracle's union-symmetrized W."""
    x = rng.normal(size=(90, 6))
    W, *_ = ref.build_affinity(x, 8, "auto")
    w_t, _ = tdm.dense_affinity(tdm.build_dense_graph(_t(x), 8), _t(x))
    np.testing.assert_allclose(w_t.numpy(), W.toarray(), atol=ATOL)


@pytest.mark.parametrize("epsilon", ["auto", 0.9])
def test_dense_forward_backward_match_jax(rng, epsilon):
    n, k_lab, l, k = 100, 20, 4, 7
    x = rng.normal(size=(n, 5))
    y = np.eye(l)[rng.integers(0, l, k_lab)]
    gbar = rng.normal(size=(n - k_lab, l))
    auto = epsilon == "auto"

    gj = jdm.build_dense_graph(jnp.asarray(x), k, epsilon)
    pred_j, (w_j, deg_j, chol_j) = jdm.dense_forward(gj, jnp.asarray(y), 0.07)
    gx_j = jdm.dense_backward(gj, jnp.asarray(y), pred_j, jnp.asarray(x),
                              chol_j, jnp.asarray(gbar), auto, w=w_j)

    gt = tdm.build_dense_graph(_t(x), k, epsilon)
    pred_t, (w_t, deg_t, fac) = tdm.dense_forward(gt, _t(y), 0.07, _t(x),
                                                  "auto")
    assert int(fac.info) == 0
    gx_t = tdm.dense_backward(gt, _t(y), pred_t, _t(x), fac, _t(gbar), auto,
                              w=w_t)
    # V recomputed from x through K1's plain version, not from the kept W
    gx_t_v = tdm.dense_backward(gt, _t(y), pred_t, _t(x), fac, _t(gbar), auto)

    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), atol=1e-10)
    np.testing.assert_allclose(deg_t.numpy(), np.asarray(deg_j), atol=ATOL)
    np.testing.assert_allclose(fac.chol.numpy(), np.asarray(chol_j),
                               atol=1e-10)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), atol=1e-10)
    np.testing.assert_allclose(gx_t_v.numpy(), gx_t.numpy(), atol=ATOL)


def test_dense_affinity_rejects_unknown_kernel_mode(rng):
    g = tdm.build_dense_graph(_t(rng.normal(size=(20, 3))), 4)
    for mode in ("on", "off"):
        with pytest.raises(ValueError, match="use_kernel"):
            tdm.dense_affinity(g, use_kernel=mode)
    # off the CPU, W comes from K1 only: without x there is no plain route
    meta = tdm.DenseGraph(*(t.to("meta") for t in g))
    with pytest.raises(ValueError, match="needs the features x"):
        tdm.dense_affinity(meta)
