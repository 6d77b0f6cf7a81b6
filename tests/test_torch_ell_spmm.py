"""Kernel P3's plain version, and the ELL solve that runs it, against the
JAX package in float64 on the CPU.

* ``ell_gather_spmm_plain`` on the port's ``build_sym_ell`` structure
  against the slot part of JAX's ``ops/graph.py::ell_spmm`` on JAX's (its
  overflow values zeroed), with and without hub rows whose in-edges
  overflow the slots, at l = 3, 10 and 37: within 1e-12;
* the port's ``ell_spmm``, whose slot sum goes through
  ``ell_gather_spmm`` once a call, against JAX's whole ``ell_spmm``;
* ``transductive_laplace(mode='ell')`` against JAX's at 400 nodes, with
  and without overflow: pred within 1e-8, the same argmax, the same CG
  iterations within one, and ``ell_gather_spmm`` called exactly
  iterations + 2 times (the right-hand side, the start residual and one
  a CG step), the count ``chip_smoke.py`` holds the card's launches to.

* ``SymEll.cnt``, each row's slots in use, on ``build_sym_ell``'s output
  with masked edges (coincident rows) and with an overflow list: k plus
  the row's in-slots, the last slot that holds a value plus one wherever
  the row has an in-edge, and nothing but padding past it; the plain
  version's sum over each row's count equals its sum over every slot.

On CPU tensors the wrapper runs the plain version and its launch count
does not move.  The row-sharded solve over two ranks is held to the
single-device ELL solve in ``tests/test_torch_parallel.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearninglayer_tpu_torch.ops.graph as tg
import graphlearninglayer_tpu_torch.ops.transductive as tt
from graphlearninglayer_tpu.ops import graph as jg
from graphlearninglayer_tpu.ops import transductive as jt
from graphlearninglayer_tpu_torch.ops.kernels import ell_spmm as p3

N_GRAPH, D, KNN = 300, 10, 8


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_ell(x, vec, cap, ovf_cap):
    """JAX's ELL product of ``vec``: its slot part and the whole."""
    g = jg.build_graph(x, KNN)
    w, _ = jg.edge_weights(g)
    ell = jg.build_sym_ell(g, w, cap, ovf_cap)
    slots = ell._replace(ovf_val=jnp.zeros_like(ell.ovf_val))
    return jg.ell_spmm(slots, vec), jg.ell_spmm(ell, vec)


def _counting(monkeypatch, module):
    """Replace ``module.ell_gather_spmm`` by a wrapper that counts calls."""
    calls = []
    real = module.ell_gather_spmm
    monkeypatch.setattr(module, "ell_gather_spmm",
                        lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("l", [3, 10, 37])
@pytest.mark.parametrize("overflow", [False, True])
def test_ell_gather_spmm_matches_jax(monkeypatch, overflow, l):
    rng = np.random.default_rng(l)
    x = rng.normal(size=(N_GRAPH, D))
    vec = rng.normal(size=(N_GRAPH, l))
    g = tg.build_graph(torch.tensor(x), KNN)
    w, _ = tg.edge_weights(g)
    max_deg = int(tg.max_in_degree(g))
    if overflow:              # hub edges beyond the cap go to the COO
        cap = max(1, max_deg // 2)
        ovf_cap = int(tg.overflow_count(g, cap))
        assert ovf_cap > 0
    else:
        cap, ovf_cap = tg.ell_cap(max_deg), 0
    slots_j, full_j = _jax_ell(jnp.asarray(x), jnp.asarray(vec), cap,
                               ovf_cap)
    ell = tg.build_sym_ell(g, w, cap, ovf_cap)
    assert ell.nbr.shape == (N_GRAPH, KNN + cap)
    v = torch.tensor(vec)
    before = p3.ell_gather_spmm.launches
    for got in (p3.ell_gather_spmm_plain(ell.nbr, ell.val, v),
                p3.ell_gather_spmm(ell.nbr, ell.val, v)):
        assert got.dtype == torch.float64 and got.shape == (N_GRAPH, l)
        np.testing.assert_allclose(got.numpy(), np.asarray(slots_j),
                                   atol=1e-12, rtol=0)
    calls = _counting(monkeypatch, tg)
    np.testing.assert_allclose(tg.ell_spmm(ell, v).numpy(),
                               np.asarray(full_j), atol=1e-12, rtol=0)
    assert len(calls) == 1
    # CPU tensors run the plain version: the kernel's count does not move
    assert p3.ell_gather_spmm.launches == before


@pytest.mark.parametrize("cap_limit", [512, 32])
def test_ell_solve_matches_jax(monkeypatch, cap_limit):
    """Clustered unit rows, 400 nodes, 40 labeled, k = 20; a cap limit of
    32 slots sends the in-edges of the hub rows to the overflow list."""
    rng = np.random.default_rng(11)
    n, l, k_lab = 400, 4, 40
    centers = rng.normal(size=(l, 12)) * 3.0
    lab = rng.integers(0, l, n)
    x = centers[lab] + rng.normal(size=(n, 12))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.eye(l)[lab[:k_lab]]
    kw = dict(knn_num=20, mode="ell", ell_cap_limit=cap_limit,
              return_info=True)
    g = tg.build_graph(torch.tensor(x), 20, tiled=True)
    assert (int(tg.max_in_degree(g)) > cap_limit) == (cap_limit == 32)
    pj, it_j, _ = jt.transductive_laplace(jnp.asarray(x), jnp.asarray(y),
                                          **kw)
    calls = _counting(monkeypatch, tg)
    pt, it_t, err_t = tt.transductive_laplace(torch.tensor(x),
                                              torch.tensor(y), **kw)
    pj = np.asarray(pj)
    assert abs(it_t - int(it_j)) <= 1 and err_t <= 1e-10
    np.testing.assert_allclose(pt.numpy(), pj, atol=1e-8, rtol=0)
    np.testing.assert_array_equal(pt.numpy().argmax(1), pj.argmax(1))
    assert len(calls) == it_t + 2


def test_ell_gather_spmm_checks_its_inputs():
    nbr = torch.zeros((4, 3), dtype=torch.int64)
    val, x = torch.ones((4, 3)), torch.ones((5, 2))
    with pytest.raises(ValueError, match="must be"):
        p3.ell_gather_spmm(nbr, val[:, :2], x)
    with pytest.raises(ValueError, match="must be"):
        p3.ell_gather_spmm(nbr, val, x[0])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        p3.ell_gather_spmm(nbr.to("meta"), val.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="counts must be"):
        p3.ell_gather_spmm(nbr, val, x, torch.ones(3, dtype=torch.int32))


@pytest.mark.parametrize("l", [3, 10])
@pytest.mark.parametrize("overflow", [False, True])
def test_sym_ell_counts_end_each_rows_slots(overflow, l):
    rng = np.random.default_rng(20 + l)
    x = rng.normal(size=(N_GRAPH, D))
    x[150:160] = x[10:20]           # coincident pairs: masked edges
    g = tg.build_graph(torch.tensor(x), KNN)
    assert bool((g.coef[:, 1:] == 0).any())
    w, _ = tg.edge_weights(g)
    max_deg = int(tg.max_in_degree(g))
    cap = max(1, max_deg // 2) if overflow else tg.ell_cap(max_deg)
    ovf_cap = int(tg.overflow_count(g, cap))
    assert (ovf_cap > 0) == overflow
    ell = tg.build_sym_ell(g, w, cap, ovf_cap)
    cnt = ell.cnt
    assert cnt.dtype == torch.int32 and cnt.shape == (N_GRAPH,)
    indeg = torch.bincount(g.nbr[g.coef > 0], minlength=N_GRAPH)
    assert torch.equal(cnt.long(), KNN + indeg.clamp_max(cap))
    slot = torch.arange(ell.nbr.shape[1])
    past = slot[None, :] >= cnt[:, None]
    assert not bool(ell.val[past].any()) and not bool(ell.nbr[past].any())
    last = torch.where(ell.val != 0, slot, -1).amax(1) + 1
    has_in = indeg > 0
    assert torch.equal(cnt[has_in].long(), last[has_in])
    assert bool((cnt[~has_in] == KNN).all())
    # a reweighted structure keeps the counts
    assert tg.ell_reweight(g, ell, w * 2.0).cnt is ell.cnt
    v = torch.tensor(rng.normal(size=(N_GRAPH, l)))
    np.testing.assert_allclose(
        p3.ell_gather_spmm_plain(ell.nbr, ell.val, v, cnt).numpy(),
        p3.ell_gather_spmm_plain(ell.nbr, ell.val, v).numpy(),
        atol=1e-12, rtol=0)
    before = p3.ell_gather_spmm.launches
    np.testing.assert_allclose(
        p3.ell_gather_spmm(ell.nbr, ell.val, v, cnt).numpy(),
        p3.ell_gather_spmm_plain(ell.nbr, ell.val, v).numpy(),
        atol=1e-12, rtol=0)
    assert p3.ell_gather_spmm.launches == before
