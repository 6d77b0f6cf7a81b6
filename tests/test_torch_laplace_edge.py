"""Edge mode and the CG solver of the port's Laplace-learning op.

Held, in float64 on the CPU, against
  * the JAX package's ``laplace_learning(mode='edge')`` with the same solver
    on the same x: pred within 1e-10 absolute, dX within 1e-8 of its
    largest entry (same arithmetic in another summation order; the CG
    solves stop at the same tolerance, 1e-10, on each side);
  * the port's dense mode (``tests/test_dense_mode.py``'s equivalence
    check, with its tolerances 1e-9 / 1e-8);
  * CG against the Cholesky solver within 1e-6 (both run to 1e-10, so the
    bar leaves room for the preconditioned residual's scaling).

Each JAX side is compiled as one ``jax.jit`` program.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.ops import laplace_learning as jax_laplace
from graphlearninglayer_tpu_torch.ops import laplace as tlap
from graphlearninglayer_tpu_torch.ops import laplace_learning
from tests.oracle import reference_op as ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU ops are tiny: one thread runs them faster, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, D, K_LAB, L, K = 130, 11, 25, 4, 8


@functools.lru_cache(maxsize=None)
def _jax_fwd_bwd(solver, epsilon, tau):
    def loss(x, y, gbar):
        pred = jax_laplace(x, y, tau=tau, epsilon=epsilon, k=K,
                           solver=solver, mode="edge", grad_warn=None)
        return jnp.sum(pred * gbar), pred

    return jax.jit(jax.grad(loss, has_aux=True))


def _problem(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    y = ref.one_hot(rng.integers(0, L, K_LAB), L)
    gbar = rng.normal(size=(N - K_LAB, L))
    return x, y, gbar


def _port(x, y, gbar, **kw):
    xt = torch.tensor(x, requires_grad=True)
    stats = {}
    pred = laplace_learning(xt, torch.tensor(y), k=K, stats=stats, **kw)
    (pred * torch.tensor(gbar)).sum().backward()
    return pred.detach().numpy(), xt.grad.numpy(), stats


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
@pytest.mark.parametrize("epsilon,tau", [("auto", 0.07), (1.0, 0.05)])
def test_edge_mode_matches_jax_and_dense(solver, epsilon, tau):
    x, y, gbar = _problem(7)
    want_gx, want = _jax_fwd_bwd(solver, epsilon, tau)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(gbar))
    want, want_gx = np.asarray(want), np.asarray(want_gx)
    got, gx, stats = _port(x, y, gbar, tau=tau, epsilon=epsilon,
                           solver=solver, mode="edge")
    np.testing.assert_allclose(got, want, atol=1e-10)
    np.testing.assert_allclose(gx, want_gx, atol=1e-8 * np.abs(want_gx).max())
    if solver == "cg":
        assert stats["cg_iters"] > 0 and stats["cg_iters_bwd"] > 0
        assert "chol_info" not in stats
    else:
        assert int(stats["chol_info"]) == 0

    dense, dense_gx, _ = _port(x, y, gbar, tau=tau, epsilon=epsilon,
                               mode="dense")
    if solver == "cholesky":
        np.testing.assert_allclose(got, dense, atol=1e-9)
        np.testing.assert_allclose(gx, dense_gx, atol=1e-8)
    else:
        np.testing.assert_allclose(got, dense, atol=1e-6)
        np.testing.assert_allclose(gx, dense_gx,
                                   atol=1e-6 * np.abs(dense_gx).max())
    torch.testing.assert_close(stats["out_norm"],
                               torch.tensor(np.linalg.norm(gx)))


def test_auto_mode_dispatch_and_rules(monkeypatch):
    x, y, _ = _problem(3)
    xt, yt = torch.tensor(x[:40]), torch.tensor(y[:8])
    seen = []
    for name in ("_LaplaceDense", "_LaplaceEdge"):
        op = getattr(tlap, name)
        monkeypatch.setattr(op, "apply", lambda *a, _o=op.apply, _n=name:
                            seen.append(_n) or _o(*a))
    laplace_learning(xt, yt, tau=0.07, k=5)
    laplace_learning(xt, yt, tau=0.07, k=5, solver="cg")
    monkeypatch.setattr(tlap, "DENSE_MAX_N", 39)
    laplace_learning(xt, yt, tau=0.07, k=5)
    assert seen == ["_LaplaceDense", "_LaplaceEdge", "_LaplaceEdge"]
    with pytest.raises(ValueError, match="requires solver='cholesky'"):
        laplace_learning(xt, yt, k=5, mode="dense", solver="cg")
    with pytest.raises(ValueError, match="unknown solver"):
        laplace_learning(xt, yt, k=5, solver="lu")
    with pytest.raises(ValueError, match="unknown mode"):
        laplace_learning(xt, yt, k=5, mode="sparse")
