"""Kernel K1 of the port (``ops/kernels/affinity.py``).

On the CPU the wrapper runs K1's plain version, which is held against the
JAX package's Pallas kernel in interpret mode at the JAX test's own bar
(atol 1e-6 in float32, n=384 and the non-divisible n=300, d=12, k=9;
tests/test_pallas_kernels.py).  The CUDA kernel itself is held against the
plain version by the ``cuda``-marked tests in tests/test_torch_cuda.py,
which run only on a machine with a card (and by chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.ops.dense_mode import build_dense_graph
from graphlearninglayer_tpu.ops.kernels.affinity import \
    fused_affinity_sym as pallas_affinity_sym
from graphlearninglayer_tpu_torch.ops import dense_mode as tdm
from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1


def _inputs(rng, n, d=12, k=9):
    x = rng.normal(size=(n, d)).astype(np.float32)
    g = build_dense_graph(jnp.asarray(x), k, "auto")
    return (x, np.asarray(g.eps, np.float32), np.asarray(g.m_raw, np.float32))


@pytest.mark.parametrize("n", [384, 300])
def test_plain_matches_pallas_interpret(rng, n):
    x, eps, m_raw = _inputs(rng, n)
    want = pallas_affinity_sym(jnp.asarray(x), jnp.asarray(eps),
                               jnp.asarray(m_raw), tm=128, tn=128,
                               interpret=True)
    got = k1.fused_affinity_sym_plain(torch.tensor(x), torch.tensor(eps),
                                      torch.tensor(m_raw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_wrapper_uses_plain_on_cpu_without_launching(rng):
    x, eps, m_raw = (torch.tensor(a) for a in _inputs(rng, 96, d=5, k=6))
    before = k1.fused_affinity_sym.launches
    got = k1.fused_affinity_sym(x, eps, m_raw)
    assert k1.fused_affinity_sym.launches == before
    torch.testing.assert_close(got, k1.fused_affinity_sym_plain(x, eps, m_raw),
                               rtol=0, atol=0)
    # the dense op's 'auto' path goes through the same wrapper
    g = tdm.build_dense_graph(x, 6)
    tdm.dense_affinity(g, x)
    assert k1.fused_affinity_sym.launches == before


def test_wrapper_checks_shapes_and_devices(rng):
    x, eps, m_raw = (torch.tensor(a) for a in _inputs(rng, 40, d=4, k=5))
    with pytest.raises(ValueError, match="shapes"):
        k1.fused_affinity_sym(x, eps[:-1], m_raw)
    with pytest.raises(ValueError, match="shapes"):
        k1.fused_affinity_sym(x, eps, m_raw[:, :-1])
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        k1.fused_affinity_sym(x[0], eps, m_raw)
    with pytest.raises(ValueError, match="device"):
        k1.fused_affinity_sym(x, eps.to("meta"), m_raw)
