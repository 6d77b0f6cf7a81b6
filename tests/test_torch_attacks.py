"""The port's attacks (``attack/``) against the JAX package's, in float64.

The encoder is tests/test_attacks.py's fixed random linear-tanh map (16
base rows, 24 batch rows, 12 input dims, 8 features, 3 classes), so the
graph head is the only other nonlinearity; the same numpy draws feed both
sides.  Parity runs at the adversarial drivers' tau = 0 with k = 6; the
epsilons are exact in float32, since the JAX FGSM builder passes its
epsilon as a float32 scalar.  Then tests/test_attacks.py's constraint-set
tests, on the port (tau = 0.07).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graphlearninglayer_tpu.attack as jattack
from graphlearninglayer_tpu.models import l2_normalize as jl2n
from graphlearninglayer_tpu_torch import attack as tattack
from graphlearninglayer_tpu_torch.attack import pgd as tpgd
from graphlearninglayer_tpu_torch.attack.fgsm import gl_loss
from graphlearninglayer_tpu_torch.models import l2_normalize
from graphlearninglayer_tpu_torch.ops import laplace_learning
from graphlearninglayer_tpu_torch.train.losses import custom_ce_loss

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(rng, n_base=16, n_batch=24, dim=12, l=3):
    """numpy draws, then each side's encoder and inputs."""
    w = rng.normal(size=(dim, 8))
    base = rng.normal(size=(n_base, dim))
    base_labels = rng.integers(0, l, n_base)
    images = rng.normal(size=(n_batch, dim))
    labels = rng.integers(0, l, n_batch)
    jw, tw = jnp.asarray(w), torch.tensor(w)
    return dict(
        l=l,
        jax=(lambda x: jl2n(jnp.tanh(x @ jw)), jnp.asarray(base),
             jnp.asarray(base_labels), jnp.asarray(images),
             jnp.asarray(labels)),
        torch=(lambda x: l2_normalize(torch.tanh(x @ tw)),
               torch.tensor(base), torch.tensor(base_labels),
               torch.tensor(images), torch.tensor(labels)))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


@pytest.mark.parametrize("kind", ["fgsm", "ifgsm"])
def test_fast_gradient_matches_jax(rng, kind):
    s = _setup(rng)
    jenc, jb, jbl, jx, jy = s["jax"]
    tenc, tb, tbl, tx, ty = s["torch"]
    eps = 0.25                       # ifgsm: 25 steps of 0.05
    jadv, jpred = jattack.make_gl_fast_gradient_attack(
        jenc, s["l"], tau=0.0, k=6, grad_warn=None)(
        jb, jbl, jx, jy, eps, kind, -10.0, 10.0)
    tadv, tpred = tattack.make_gl_fast_gradient_attack(
        tenc, s["l"], tau=0.0, k=6, **CPU)(tb, tbl, tx, ty, eps, kind,
                                            -10.0, 10.0)
    _close(tadv, jadv, 1e-9)
    assert np.array_equal(tpred.numpy(), np.asarray(jpred))
    assert (tadv - tx).abs().max().item() > 0.2   # the attack moved it


def test_mlp_fast_gradient_matches_jax(rng):
    wcls = rng.normal(size=(12, 3))
    images = rng.normal(size=(10, 12))
    labels = rng.integers(0, 3, 10)
    jw, tw = jnp.asarray(wcls), torch.tensor(wcls)
    jadv, jpred = jattack.make_mlp_fast_gradient_attack(
        lambda x: jax.nn.log_softmax(x @ jw, axis=1))(
        jnp.asarray(images), jnp.asarray(labels), 0.25, "ifgsm", -1.5, 1.5)
    tadv, tpred = tattack.make_mlp_fast_gradient_attack(
        lambda x: torch.log_softmax(x @ tw, dim=1), **CPU)(
        images, labels, 0.25, "ifgsm", -1.5, 1.5)
    _close(tadv, jadv, 1e-9)
    assert np.array_equal(tpred.numpy(), np.asarray(jpred))


def test_pgd_iterations_from_jax_start_match_jax(rng):
    """The port's iterations, fed JAX's own uniform start, land on JAX's
    perturb output."""
    s = _setup(rng)
    jenc, jb, jbl, jx, jy = s["jax"]
    tenc, tb, tbl, tx, ty = s["torch"]
    eps, alpha, iters, lo, hi = 0.3, 0.1, 5, -1.5, 1.5
    key = jax.random.PRNGKey(3)
    jadv = jattack.make_gl_pgd_perturb(jenc, s["l"], tau=0.0, k=6, eps=eps,
                                       alpha=alpha, num_iters=iters)(
        jb, jbl, jx, jy, key, lo, hi)
    noise = jax.random.uniform(key, jx.shape, jx.dtype, -eps, eps)
    start = torch.clamp(tx + torch.tensor(np.asarray(noise)), lo, hi)
    loss = gl_loss(tenc, s["l"], dict(tau=0.0, k=6), tb, tbl, ty, [])
    tadv = tpgd.pgd_iterations(loss, start, tx, alpha, eps, iters, lo, hi)
    _close(tadv, jadv, 1e-9)
    assert np.abs(np.asarray(jadv) - np.asarray(jx)).max() > 0.25


@pytest.mark.parametrize("head", ["gl", "mlp"])
def test_cw_matches_jax(rng, head):
    """Ten Adam iterations in tanh space; the adversarial images within
    1e-6, the initial and final predictions identical."""
    s = _setup(rng)
    jenc, jb, jbl, jx, _ = s["jax"]
    tenc, tb, tbl, tx, _ = s["torch"]
    if head == "gl":
        jout = jattack.make_gl_cw_attack(jenc, s["l"], tau=0.0, k=6,
                                         iters=10)(jb, jbl, jx, 50.0,
                                                   -4.0, 4.0)
        tout = tattack.make_gl_cw_attack(tenc, s["l"], tau=0.0, k=6,
                                         iters=10, **CPU)(tb, tbl, tx, 50.0,
                                                          -4.0, 4.0)
    else:
        wcls = rng.normal(size=(12, 3))
        jw, tw = jnp.asarray(wcls), torch.tensor(wcls)
        jout = jattack.make_mlp_cw_attack(
            lambda x: jax.nn.log_softmax(x @ jw, axis=1), iters=10)(
            jx, 50.0, -4.0, 4.0)
        tout = tattack.make_mlp_cw_attack(
            lambda x: torch.log_softmax(x @ tw, dim=1), iters=10, **CPU)(
            tx, 50.0, -4.0, 4.0)
    _close(tout[0], jout[0], 1e-6)
    for t, j in zip(tout[1:], jout[1:]):
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert (tout[0] - tx).abs().max().item() > 1e-3


def test_torch_adam_places_eps_as_optax_adam():
    """torch.optim.Adam and optax.adam on the same gradient sequence,
    where the second moment is tiny against eps**2 (so the two
    placements of eps, inside or outside the root, would differ)."""
    g = np.random.default_rng(0).normal(size=(6, 4)) * np.logspace(
        -12, 0, 4)
    tx = optax.adam(0.005)
    p = jnp.zeros(4)
    state = tx.init(p)
    w = torch.zeros(4, dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([w], lr=0.005)
    for gi in g:
        upd, state = tx.update(jnp.asarray(gi), state, p)
        p = optax.apply_updates(p, upd)
        w.grad = torch.tensor(gi)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(p),
                               rtol=1e-12, atol=1e-18)


def test_grad_warn_reads_the_op_norms(rng, capsys):
    s = _setup(rng)
    tenc, tb, tbl, tx, ty = s["torch"]
    for thresh, warns in ((1e-12, True), (None, False), (1e12, False)):
        tattack.make_gl_fast_gradient_attack(
            tenc, s["l"], tau=0.07, k=6, grad_warn=thresh, **CPU)(
            tb, tbl, tx, ty, 0.25, "fgsm", -10.0, 10.0)
        assert ("possible exploding gradient" in capsys.readouterr().out) \
            == warns


# tests/test_attacks.py's constraint-set tests, on the port


def _gl_loss_value(enc, base, base_labels, images, labels, l):
    feats = enc(torch.cat([base, images]))
    y = torch.nn.functional.one_hot(base_labels, l).to(feats.dtype)
    pred = laplace_learning(feats, y, tau=0.07, k=6)
    return float(custom_ce_loss(pred, labels))


def test_fgsm_increases_loss_within_ball(rng):
    s = _setup(rng)
    enc, base, base_labels, images, labels = s["torch"]
    attack = tattack.make_gl_fast_gradient_attack(enc, s["l"], tau=0.07,
                                                  k=6, **CPU)
    adv, pred = attack(base, base_labels, images, labels, 0.25, "fgsm",
                       -10.0, 10.0)
    assert (adv - images).abs().max().item() <= 0.25 + 1e-6
    clean = _gl_loss_value(enc, base, base_labels, images, labels, s["l"])
    attacked = _gl_loss_value(enc, base, base_labels, adv, labels, s["l"])
    assert attacked > clean


def test_ifgsm_stronger_than_fgsm(rng):
    s = _setup(rng)
    enc, base, base_labels, images, labels = s["torch"]
    attack = tattack.make_gl_fast_gradient_attack(enc, s["l"], tau=0.07,
                                                  k=6, **CPU)
    adv_f, _ = attack(base, base_labels, images, labels, 0.3, "fgsm",
                      -10.0, 10.0)
    adv_i, _ = attack(base, base_labels, images, labels, 0.3, "ifgsm",
                      -10.0, 10.0)
    assert (adv_i - images).abs().max().item() <= 0.3 + 1e-6
    lf = _gl_loss_value(enc, base, base_labels, adv_f, labels, s["l"])
    li = _gl_loss_value(enc, base, base_labels, adv_i, labels, s["l"])
    assert li >= 0.8 * lf


def test_mlp_fgsm(rng):
    wcls = torch.tensor(rng.normal(size=(12, 3)))

    def classify(images):
        return torch.log_softmax(images @ wcls, dim=1)

    images = torch.tensor(rng.normal(size=(10, 12)))
    labels = torch.argmax(classify(images), dim=1)      # start correct
    attack = tattack.make_mlp_fast_gradient_attack(classify, **CPU)
    _, pred = attack(images, labels, 0.5, "fgsm", -10.0, 10.0)
    assert (pred != labels).double().mean().item() > 0.3


def test_cw_attack_flips_and_stays_close(rng):
    s = _setup(rng)
    enc, base, base_labels, images, _ = s["torch"]
    attack = tattack.make_gl_cw_attack(enc, s["l"], tau=0.07, k=6, iters=30,
                                       **CPU)
    adv, init_pred, final_pred = attack(base, base_labels, images, 50.0,
                                        -4.0, 4.0)
    assert bool(torch.isfinite(adv).all())
    assert adv.min().item() >= -4.0 - 1e-5 and adv.max().item() <= 4.0 + 1e-5
    assert (final_pred != init_pred).double().mean().item() > 0.2


@pytest.mark.parametrize("style", ["closure", "live_model"])
def test_pgd_perturb_constraints(rng, style):
    s = _setup(rng)
    enc, base, base_labels, images, labels = s["torch"]
    images = torch.clamp(images, -1.2, 1.2)
    kw = dict(tau=0.07, k=6, eps=0.3, alpha=0.1, num_iters=5, **CPU)
    gen = torch.Generator().manual_seed(0)
    if style == "closure":
        adv = tattack.make_gl_pgd_perturb(enc, s["l"], **kw)(
            base, base_labels, images, labels, gen, -1.5, 1.5)
    else:
        stats: list = []
        adv = tpgd.make_gl_pgd_perturb_p(lambda model, x: model(x), s["l"],
                                         **kw)(
            enc, base, base_labels, images, labels, gen, -1.5, 1.5, stats)
        assert len(stats) == 5 and all("out_norm" in d for d in stats)
    assert (adv - images).abs().max().item() <= 0.3 + 1e-6
    assert adv.min().item() >= -1.5 - 1e-6 and adv.max().item() <= 1.5 + 1e-6
    clean = _gl_loss_value(enc, base, base_labels, images, labels, s["l"])
    attacked = _gl_loss_value(enc, base, base_labels, adv, labels, s["l"])
    assert attacked > clean
