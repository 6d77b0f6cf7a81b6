"""The port's FGSM / IFGSM attack with its rows sharded over gloo CPU ranks
(``attack/fgsm.py::make_sharded_gl_fast_gradient_attack``), against the
port's unsharded attack and the JAX package's attack, in float64.

The encoder and data are tests/test_torch_attacks.py's: a fixed random
linear-tanh map, 16 base + 24 batch rows of 12 dims, 8 features, 3
classes, tau 0 and k 6, whose graph stays connected (tau 0 needs every
unlabeled component to reach a labeled node).  The base and the batch are
each split over the ranks: two ranks hold 8 + 8 base and 12 + 12 batch
rows, three ranks 6 + 5 + 5 and 8 + 8 + 8.
Bars: the sharded attack's adversarial images within 1e-10 of the
unsharded attack's and its predictions equal, its first-step input
gradient within 1e-10; against JAX the gradient within 1e-8 of the
largest entry, the adversarial images within 1e-9 (as the unsharded
attack's JAX test) and the predictions equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearninglayer_tpu.attack as jattack
from graphlearninglayer_tpu.models import l2_normalize as jl2n
from graphlearninglayer_tpu.ops import laplace_learning as jlaplace
from graphlearninglayer_tpu.train.losses import custom_ce_loss as jce
from graphlearninglayer_tpu_torch.parallel import spawn_ranks
from tests import torch_ranks

WORLDS = (2, 3)


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    case = dict(w=rng.normal(size=(12, 8)), base=rng.normal(size=(16, 12)),
                base_labels=rng.integers(0, 3, 16),
                images=rng.normal(size=(24, 12)),
                labels=rng.integers(0, 3, 24), l=3, k=6, eps=0.25)
    jw = jnp.asarray(case["w"])
    jb, jbl, jx, jy = (jnp.asarray(case[k]) for k in
                       ("base", "base_labels", "images", "labels"))

    def jenc(x):
        return jl2n(jnp.tanh(x @ jw))

    def jloss(img):
        feats = jenc(jnp.concatenate([jb, img]))
        y = jax.nn.one_hot(jbl, 3, dtype=feats.dtype)
        return jce(jlaplace(feats, y, tau=0.0, epsilon="auto", k=6,
                            grad_warn=None), jy)

    jatk = jattack.make_gl_fast_gradient_attack(jenc, 3, tau=0.0, k=6,
                                                grad_warn=None)
    want = {"grad": np.asarray(jax.jit(jax.grad(jloss))(jx))}
    for kind in ("fgsm", "ifgsm"):
        adv, pred = jatk(jb, jbl, jx, jy, case["eps"], kind, -10.0, 10.0)
        want[kind] = dict(adv=np.asarray(adv), pred=np.asarray(pred))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = torch_ranks.attack_case_run(case)
        ranks = {w: spawn_ranks(torch_ranks.attack_worker, w, (case,),
                                device="cpu", threads=1) for w in WORLDS}
    finally:
        torch.set_num_threads(n)
    return dict(case=case, jax=want, plain=plain, ranks=ranks)


def _gathered_grad(ranks):
    """The ranks' gradient rows, in rank order: the whole batch's."""
    return np.concatenate([r["grad"] for r in ranks])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["fgsm", "ifgsm"])
def test_sharded_attack_equals_unsharded_attack(run, world, kind):
    ranks, plain = run["ranks"][world], run["plain"]
    assert [r["lo"] for r in ranks] == {2: [0, 12], 3: [0, 8, 16]}[world]
    for r in ranks:
        # every rank returns the whole adversarial batch, the same one
        np.testing.assert_array_equal(r[kind]["adv"], ranks[0][kind]["adv"])
        np.testing.assert_array_equal(r[kind]["pred"],
                                      ranks[0][kind]["pred"])
        assert r[kind]["op_calls"] == plain[kind]["op_calls"]
    got = ranks[0][kind]
    assert got["adv"].shape == plain[kind]["adv"].shape
    np.testing.assert_allclose(got["adv"], plain[kind]["adv"], rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(got["pred"], plain[kind]["pred"])
    np.testing.assert_allclose(_gathered_grad(ranks), plain["grad"], rtol=0,
                               atol=1e-10)
    # the attack moved the images, inside the epsilon ball
    step = np.abs(got["adv"] - run["case"]["images"]).max()
    assert 0.2 < step <= run["case"]["eps"] + 1e-12


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_attack_matches_jax(run, world):
    ranks, want = run["ranks"][world], run["jax"]
    grad = _gathered_grad(ranks)
    scale = np.abs(want["grad"]).max()
    assert np.abs(grad - want["grad"]).max() <= 1e-8 * scale
    np.testing.assert_allclose(run["plain"]["grad"], want["grad"], rtol=0,
                               atol=1e-8 * scale)
    for kind in ("fgsm", "ifgsm"):
        got = ranks[0][kind]
        np.testing.assert_allclose(got["adv"], want[kind]["adv"], rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(got["pred"], want[kind]["pred"])
