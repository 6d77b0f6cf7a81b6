"""The port's Laplace-learning op (``ops/laplace.py``, dense mode).

Held, in float64 on the CPU, against
  * the scipy oracle (tests/oracle/reference_op.py) at the four CASES of
    tests/test_laplace_parity.py, with that file's tolerances (forward atol
    1e-8 / rtol 1e-7, backward atol 1e-7 / rtol 1e-6);
  * the JAX package's ``laplace_learning`` on the same x;
  * finite differences via ``torch.autograd.gradcheck``, at the size of
    tests/test_gradcheck.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.ops import laplace_learning as jax_laplace
from graphlearninglayer_tpu_torch.ops import laplace as tlap
from graphlearninglayer_tpu_torch.ops import laplace_learning
from tests.oracle import reference_op as ref


CASES = [
    dict(tau=0.07, epsilon="auto"),   # FullySup convention (temp-as-tau)
    dict(tau=0.0, epsilon="auto"),    # adversarial-driver convention
    dict(tau=1e-8, epsilon="auto"),   # numpy eval convention
    dict(tau=0.05, epsilon=1.0),      # fixed-bandwidth mode
]


def _problem(rng, n=140, d=12, k_lab=30, l=5):
    x = rng.normal(size=(n, d))
    y = ref.one_hot(rng.integers(0, l, size=k_lab), l)
    return x, y


def _grad(x, y, gbar, **kw):
    xt = torch.tensor(x, requires_grad=True)
    pred = laplace_learning(xt, torch.tensor(y), **kw)
    (pred * torch.tensor(gbar)).sum().backward()
    return pred.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("case", CASES)
def test_forward_backward_match_oracle(rng, case):
    x, y = _problem(rng)
    want, ctx = ref.forward(x, y, k=9, **case)
    gbar = rng.normal(size=want.shape)
    got, gx = _grad(x, y, gbar, k=9, **case)
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=1e-7)
    np.testing.assert_allclose(gx, ref.backward(ctx, gbar), atol=1e-7,
                               rtol=1e-6)


@pytest.mark.parametrize("case", [CASES[0], CASES[3]])
def test_forward_backward_match_jax(rng, case):
    x, y = _problem(rng)
    gbar = rng.normal(size=(x.shape[0] - y.shape[0], y.shape[1]))
    want = np.asarray(jax_laplace(jnp.asarray(x), jnp.asarray(y), k=9,
                                  **case))
    want_gx = np.asarray(jax.grad(
        lambda xj: jnp.sum(jax_laplace(xj, jnp.asarray(y), k=9, **case)
                           * jnp.asarray(gbar)))(jnp.asarray(x)))
    got, gx = _grad(x, y, gbar, k=9, **case)
    np.testing.assert_allclose(got, want, atol=1e-10)
    np.testing.assert_allclose(gx, want_gx, atol=1e-10)


@pytest.mark.parametrize("epsilon", ["auto", 1.2])
def test_gradcheck(rng, epsilon):
    n, d, k_lab, l, k = 40, 5, 10, 3, 6
    x = torch.tensor(rng.normal(size=(n, d)), requires_grad=True)
    y = torch.tensor(ref.one_hot(rng.integers(0, l, size=k_lab), l))
    assert torch.autograd.gradcheck(
        lambda xv: laplace_learning(xv, y, tau=0.1, epsilon=epsilon, k=k),
        (x,), eps=1e-6, atol=1e-5, rtol=1e-4)


def test_every_row_gets_gradient_and_stats_are_filled(rng):
    x, y = _problem(rng, n=60, k_lab=15, l=3)
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    stats = {}
    pred = laplace_learning(xt, yt, tau=0.07, k=7, stats=stats)
    assert int(stats["chol_info"]) == 0
    gbar = torch.tensor(rng.normal(size=tuple(pred.shape)))
    (pred * gbar).sum().backward()
    assert yt.grad is None
    assert torch.linalg.vector_norm(xt.grad[:15]) > 0  # labeled rows too
    torch.testing.assert_close(stats["grad_norm"],
                               torch.linalg.vector_norm(gbar))
    torch.testing.assert_close(stats["out_norm"],
                               torch.linalg.vector_norm(xt.grad))


def test_mode_rules():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        laplace_learning(torch.zeros(4097, 2), torch.zeros(10, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        laplace_learning(torch.zeros(50, 2), torch.zeros(10, 2), solver="cg")
    with pytest.raises(ValueError, match="requires solver='cholesky'"):
        laplace_learning(torch.zeros(50, 2), torch.zeros(10, 2), mode="dense",
                         solver="cg")


def test_exploding_grad_warning_is_host_side(capsys, monkeypatch):
    assert tlap.warn_exploding_grad(2.0, 11.0)
    assert "possible exploding gradient" in capsys.readouterr().out
    assert not tlap.warn_exploding_grad(2.0, 9.0)
    monkeypatch.setattr(tlap, "GRAD_NORM_WARN_THRESHOLD", None)
    assert not tlap.warn_exploding_grad(2.0, 11.0)
    monkeypatch.setattr(tlap, "GRAD_NORM_WARN_THRESHOLD", 2.5)
    assert tlap.warn_exploding_grad(2.0, 3.0)
