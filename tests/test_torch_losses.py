"""The port's losses (``train/losses.py``) against the JAX package's, value
and gradient, in float64 on the same numpy inputs (atol 1e-12: the same
arithmetic).  Each JAX side is one ``jax.jit`` of value-and-grad."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.train import losses as jl
from graphlearninglayer_tpu_torch.train import losses as tl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU ops are tiny: one thread runs them faster, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _probs(rng, b=12, c=5):
    p = rng.random((b, c)) + 0.05
    return p / p.sum(1, keepdims=True)


def _unit(rng, shape):
    f = rng.normal(size=shape)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


# name -> (make inputs from rng, the differentiated argument's index, kwargs)
CASES = {
    "custom_ce_loss": (lambda r: (_probs(r), r.integers(0, 5, 12)), 0, {}),
    "entropy": (lambda r: (_probs(r),), 0, {}),
    "logsumexp_loss": (lambda r: (r.normal(size=(12, 5)),), 0, {}),
    "l2_loss": (lambda r: (_probs(r),), 0, {}),
    "sym_ce_loss": (lambda r: (r.normal(size=(12, 5)),
                               r.normal(size=(12, 5))), 0, {}),
    "sup_con_loss[labels]": (lambda r: (_unit(r, (8, 2, 6)),
                                        r.integers(0, 3, 8)), 0, {}),
    "sup_con_loss[simclr]": (lambda r: (_unit(r, (8, 2, 6)),), 0, {}),
    "sup_con_loss[mask]": (lambda r: (_unit(r, (8, 3, 6)), None,
                                      (r.random((8, 8)) < 0.4) | np.eye(8,
                                      dtype=bool)), 0, {}),
    "sup_con_loss[one]": (lambda r: (_unit(r, (8, 2, 6)),
                                     r.integers(0, 3, 8)), 0,
                          dict(contrast_mode="one", temperature=0.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_jax(case):
    make, argnum, kw = CASES[case]
    name = case.split("[")[0]
    args = make(np.random.default_rng(len(case)))
    jfn = jax.jit(jax.value_and_grad(
        lambda *a: getattr(jl, name)(*a, **kw), argnums=argnum))
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    want, want_g = jfn(*jargs)

    targs = [None if a is None else torch.tensor(a) for a in args]
    targs[argnum].requires_grad_(True)
    got = getattr(tl, name)(*targs, **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-12)
    np.testing.assert_allclose(targs[argnum].grad.numpy(),
                               np.asarray(want_g), atol=1e-12)


def test_sup_con_rejects_bad_arguments():
    f = torch.zeros(4, 2, 3)
    with pytest.raises(ValueError, match="bsz, n_views"):
        tl.sup_con_loss(f[:, 0])
    with pytest.raises(ValueError, match="both labels and mask"):
        tl.sup_con_loss(f, torch.zeros(4), torch.eye(4))
    with pytest.raises(ValueError, match="unknown mode"):
        tl.sup_con_loss(f, contrast_mode="some")
