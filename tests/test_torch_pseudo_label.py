"""The port's pseudo-label module (``data/pseudo_label.py``) against the
JAX package's numpy module on the same inputs: every output exactly
equal."""
import numpy as np
import pytest

from graphlearninglayer_tpu.data import pseudo_label as J
from graphlearninglayer_tpu_torch.data import pseudo_label as T


def _outputs(n=200, l=5, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, l)) * 2.0
    p = np.exp(logits)
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.5, 0.8, [0.3, 0.9, 0.5, 0.7, 0.95]])
def test_convert_outputs_matches_jax(thresh):
    out = _outputs()
    got = T.convert_outputs_to_pseudo_labels(out, thresh)
    want = J.convert_outputs_to_pseudo_labels(out, thresh)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() and (got >= 0).any()


def test_thresh_length_is_checked():
    for mod in (T, J):
        with pytest.raises(ValueError, match="number of classes"):
            mod.convert_outputs_to_pseudo_labels(_outputs(), [0.5, 0.5])


@pytest.mark.parametrize("nonlinear,warmup", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_store_and_curriculum_thresholds_match_jax(nonlinear, warmup):
    out = _outputs(300, 5, seed=1)
    stores = [mod.PseudoLabelStore(300, 5, thresh=0.6) for mod in (T, J)]
    idx = np.random.default_rng(2).permutation(300)[:240]
    for s in stores:
        np.testing.assert_array_equal(s.thresh, stores[1].thresh)
        s.update_outputs(idx, out[idx])
        s.update_all_plabels()
    np.testing.assert_array_equal(stores[0].pred_labels,
                                  stores[1].pred_labels)
    np.testing.assert_array_equal(stores[0].mask(), stores[1].mask())
    got, want = (s.curriculum_thresholds(0.9, nonlinear=nonlinear,
                                         warmup=warmup) for s in stores)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # labels set by hand, then per-class and scalar threshold updates
    for s in stores:
        s.update_labels(idx[:10], np.arange(10) % 5)
        s.update_thresh([0.1, 0.2, 0.3, 0.4, 0.5])
        s.update_all_plabels()
    np.testing.assert_array_equal(stores[0].pred_labels,
                                  stores[1].pred_labels)
    for s in stores:
        s.update_thresh(0.7)
    np.testing.assert_array_equal(stores[0].thresh, stores[1].thresh)
