"""Kernels P1 and P2, the counterparts of the TPU probes in ``benchmarks/``:
their plain versions (the CPU path of each wrapper) against the numpy
checks the probes use, at the probes' shapes.

The JAX probes themselves cannot run here: they ask for a TPU's VMEM and
have no interpret mode.  The kernels are held to these plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``probes``).

* P1 (``benchmarks/probe_pallas_sort.py``): each row sorted
  (``np.sort``), the full-row top-k (``-np.sort(-x)``), both with indices
  ordered by (value, index), and ``pl.when(max > 0)``'s ``x * 2`` or ``x``;
* P2 (``benchmarks/probe_gather_support.py``): ``np.take_along_axis`` along
  axis 0 and 1 at the probe's six shapes, exactly.
"""
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu_torch.ops.kernels import row_sort as p1
from graphlearninglayer_tpu_torch.ops.kernels import take_along as p2

# the probes' draws: a (256, 512) float32 block, and for P2 (m, n) float32
# operands with int32 indices shaped like them
Q, M = 256, 512
P2_CASES = [(256, 128, 0), (8192, 128, 0), (128, 128, 1), (128, 1024, 1),
            (8, 8192, 1), (65536, 128, 0)]


def _block(q=Q, m=M, ties=False):
    rng = np.random.default_rng(0)
    if ties:        # few distinct values: every row full of equal entries
        return rng.integers(-3, 4, (q, m)).astype(np.float32)
    return rng.normal(size=(q, m)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("descending", [False, True])
def test_row_sort_matches_numpy(descending, ties):
    x = _block(ties=ties)
    sign = -1.0 if descending else 1.0
    want = sign * np.sort(sign * x, axis=-1)
    order = np.argsort(sign * x, axis=-1, kind="stable")
    before = p1.row_sort.launches
    for fn in (p1.row_sort_plain, p1.row_sort):
        vals, idx = fn(torch.from_numpy(x), descending)
        np.testing.assert_array_equal(vals.numpy(), want)
        np.testing.assert_array_equal(idx.numpy(), order)
        assert idx.dtype == torch.int64
    assert p1.row_sort.launches == before


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_scale_if_max_positive_matches_the_probe(sign):
    """The probe's check: ``x * 2 if x.max() > 0 else x``; an all-negative
    block stays as it is."""
    x = sign * np.abs(_block())
    want = x * 2.0 if x.max() > 0 else x
    before = p1.scale_if_max_positive.launches
    for fn in (p1.scale_if_max_positive_plain, p1.scale_if_max_positive):
        np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), want)
    assert p1.scale_if_max_positive.launches == before


@pytest.mark.parametrize("m,n,axis", P2_CASES)
def test_take_along_matches_numpy(m, n, axis):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(m, n)).astype(np.float32)
    idx = rng.integers(0, m if axis == 0 else n, (m, n), dtype=np.int32)
    want = np.take_along_axis(x, idx, axis=axis)
    before = p2.take_along.launches
    it = torch.from_numpy(idx).long()
    for fn in (p2.take_along_plain, p2.take_along):
        np.testing.assert_array_equal(fn(torch.from_numpy(x), it,
                                         axis).numpy(), want)
    assert p2.take_along.launches == before


def test_wrappers_check_their_inputs():
    x = torch.zeros((4, 6))
    with pytest.raises(ValueError, match="power of two"):
        p1.row_sort(x)
    with pytest.raises(ValueError, match="power of two"):
        p1.row_sort(torch.zeros((2, 2048)))
    with pytest.raises(ValueError, match="non-empty"):
        p1.scale_if_max_positive(torch.zeros((0, 4)))
    idx = torch.zeros((4, 6), dtype=torch.int64)
    with pytest.raises(ValueError, match="alike"):
        p2.take_along(x, idx[:, :3], 1)
    with pytest.raises(ValueError, match="axis"):
        p2.take_along(x, idx, 2)
