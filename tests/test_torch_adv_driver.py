"""The port's adversarial training driver (``train/adversarial_driver.py``)
and attack driver (``attack/driver.py``) on the CPU.

tests/test_adv_driver.py's three scenarios run on the port with the same
tiny synthetic config (Small-CNN, 128 train / 64 test images, batch 32, 2
base images a class, 2 PGD iterations).  Beside them: one robust GL step
from carried weights against the same step composed from the JAX package's
parts, in float64; the CLIs' argument errors and synthetic overrides; a
train-then-attack round trip through the checkpoint; and the JAX driver's
one dropout key against the port's fresh masks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graphlearninglayer_tpu.train.adversarial_driver as jad
from graphlearninglayer_tpu.attack.pgd import make_gl_pgd_perturb_p as jpgd
from graphlearninglayer_tpu.models import preact_resnet as jpreact
from graphlearninglayer_tpu.ops import laplace_learning as jlaplace
from graphlearninglayer_tpu.train.losses import custom_ce_loss as jce
from graphlearninglayer_tpu_torch.attack import driver as tdriver
from graphlearninglayer_tpu_torch.attack.fgsm import gl_loss
from graphlearninglayer_tpu_torch.attack.pgd import pgd_iterations
from graphlearninglayer_tpu_torch.models import (Dropout, PreActBlock,
                                                 PreActResNetFeat)
from graphlearninglayer_tpu_torch.train import adversarial_driver as ad
from graphlearninglayer_tpu_torch.train import create_train_state
from graphlearninglayer_tpu_torch.utils import params_from_jax

TINY = dict(n_train=128, n_test=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(module):
    return module.AdvConfig("synthetic", "smallcnn_gl", "smallcnn", -1.0,
                            1.0, 0.1, 32, 2, 0.01, 2, adam=True, gl_tau=1e-6,
                            pgd_iters=2)


@pytest.fixture()
def tiny_cfg(monkeypatch, tmp_path):
    monkeypatch.setitem(ad.DATASET_CONFIGS, "synthetic", _tiny(ad))
    monkeypatch.chdir(tmp_path)          # the attack driver writes images/
    return tmp_path


def test_natural_gl_training_learns(tiny_cfg):
    res = ad.run("gl", "natural", "synthetic", save_dir=str(tiny_cfg),
                 synth=TINY, device="cpu")
    assert np.isfinite(res["gl_acc"])
    assert res["gl_acc"] > 0.4  # well above 10-class chance (0.1)
    assert res["gl_chol_info"] == 0
    assert len(res["gl_loss"]) == 2 and all(np.isfinite(res["gl_loss"]))
    assert (tiny_cfg / "synthetic_gl_natural" / "ckpt_epoch_2.pth").is_file()


def test_robust_mlp_training_runs(tiny_cfg):
    res = ad.run("mlp", "robust", "synthetic", epochs=1,
                 save_dir=str(tiny_cfg), synth=TINY, device="cpu")
    assert np.isfinite(res["mlp_acc"])
    assert 0.0 <= res["mlp_acc"] <= 1.0


def test_eval_runs_when_test_set_smaller_than_batch(tiny_cfg, monkeypatch):
    """A test split smaller than the training batch is still evaluated (the
    eval batch caps at the split size)."""
    cfg = ad.DATASET_CONFIGS["synthetic"]
    monkeypatch.setitem(ad.DATASET_CONFIGS, "synthetic",
                        ad.AdvConfig(**{**cfg.__dict__, "batch_size": 100}))
    res = ad.run("gl", "natural", "synthetic", save_dir=str(tiny_cfg),
                 synth=TINY, device="cpu")
    assert np.isfinite(res["gl_acc"]) and res["gl_acc"] > 0.0


def test_train_then_attack_round_trip(tiny_cfg, capsys):
    """The attack driver restores what the adversarial driver saved, and
    its sweeps run on it: a robust GL net and its IFGSM and CW curves."""
    trained = ad.run("gl", "robust", "synthetic", epochs=1,
                     save_dir=str(tiny_cfg), synth=TINY, device="cpu")
    assert trained["gl_chol_info"] == 0
    out = {}
    for attack, sweep in (("ifgsm", [0.0, 0.05]), ("cw", [10.0])):
        out[attack] = tdriver.run(attack, "gl", "robust", "synthetic",
                                  ckpt_dir=str(tiny_cfg), batch_size=32,
                                  sweep=sweep, cw_iters=3, synth=TINY,
                                  device="cpu")["gl"]
    log = capsys.readouterr().out
    assert log.count(f"loaded weights from {tiny_cfg}/synthetic_gl_robust") \
        == 2
    clean, attacked = (p["accuracy"] for p in out["ifgsm"])
    assert clean > 0.4 and attacked <= clean
    # op calls a point: (iterations + the final prediction) a batch, and
    # CW's initial prediction; 2 batches of 32
    assert [p["op_calls"] for p in out["ifgsm"]] == [2, 12]
    assert out["cw"][0]["op_calls"] == 2 * (1 + 3 + 1)
    assert all(p["chol_info"] == 0 for p in out["ifgsm"] + out["cw"])
    assert [p["point"] for p in out["cw"]] == [10.0]
    assert 0.0 <= out["cw"][0]["accuracy"] <= 1.0
    assert "example grid" not in log or "skipped" in log


def test_cli_arguments_and_synth_overrides(monkeypatch):
    calls = []
    monkeypatch.setattr(ad, "run", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(tdriver, "run",
                        lambda *a, **kw: calls.append((a, kw)) or {})
    with pytest.raises(SystemExit, match="usage"):
        ad.main(["gl", "robust"])
    with pytest.raises(ValueError, match="gl, mlp, or both"):
        ad.main(["svm", "robust", "synthetic"])
    with pytest.raises(ValueError, match="natural or robust"):
        ad.main(["gl", "sturdy", "synthetic"])
    with pytest.raises(ValueError, match="unknown synthetic override"):
        ad.main(["gl", "robust", "synthetic", "bogus=1"])
    ad.main(["both", "robust", "synthetic", "3", "n_train=512",
             "synth_sep=1.5", "--dev", "cpu"])
    assert calls[-1] == (("both", "robust", "synthetic"),
                         dict(epochs=3, synth=dict(n_train=512,
                                                   class_sep=1.5),
                              device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ad.main(["gl", "natural", "mnist"])
    assert calls[-1][1] == dict(epochs=None, synth={}, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((ad.main, ["gl", "natural", "mnist"]),
                       (tdriver.main, ["fgsm", "gl", "natural", "mnist"])):
        with pytest.raises(RuntimeError, match="--dev cpu"):
            main(argv)
    with pytest.raises(SystemExit, match="usage"):
        tdriver.main(["fgsm", "gl", "robust"])
    with pytest.raises(ValueError, match="fgsm, ifgsm, or cw"):
        tdriver.main(["pgd", "gl", "robust", "synthetic"])
    tdriver.main(["cw", "mlp", "natural", "synthetic", "1", "5",
                  "n_test=64", "--dev", "cpu"])
    assert calls[-1] == (("cw", "mlp", "natural", "synthetic"),
                         dict(sweep=[1.0, 5.0], synth=dict(n_test=64),
                              device="cpu"))


def test_configs_schedules_and_optimizers():
    """The reference's values, the cifar10 clamps in NCHW, the cosine and
    staircase schedules against optax's, and each optimizer."""
    cifar = ad.DATASET_CONFIGS["cifar10"]
    jcifar = jad.DATASET_CONFIGS["cifar10"]
    for name, cfg in ad.DATASET_CONFIGS.items():
        jcfg = jad.DATASET_CONFIGS[name]
        for f in cfg.__dict__:
            if f not in ("min_val", "max_val"):
                assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
    assert cifar.min_val.shape == (1, 3, 1, 1)
    np.testing.assert_array_equal(cifar.min_val.reshape(-1),
                                  jcifar.min_val.reshape(-1))
    np.testing.assert_array_equal(cifar.max_val.reshape(-1),
                                  jcifar.max_val.reshape(-1))
    for name in ("cifar10", "mnist", "fashionmnist", "synthetic"):
        ours = ad._make_schedule(ad.DATASET_CONFIGS[name], 7)
        theirs = jad._make_schedule(jad.DATASET_CONFIGS[name], 7)
        for step in (0, 1, 69, 70, 174, 175, 1049, 1050, 5000):
            want = theirs(step) if callable(theirs) else theirs
            assert ours(step) == pytest.approx(float(want), rel=1e-6), \
                (name, step)
    assert ad._make_tx(cifar, "gl") == dict(adam=False, momentum=0.9,
                                            weight_decay=5e-4)
    mnist = ad.DATASET_CONFIGS["mnist"]
    assert ad._make_tx(mnist, "mlp")["weight_decay"] == 5e-4
    assert ad._make_tx(mnist, "gl") == dict(adam=True, weight_decay=0.0)


class _F64Numpy:
    """jax.numpy with ``float32`` read as float64 (the flax PreAct net
    casts its pooled features to float32)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_robust_gl_step_matches_jax_composition(rng, monkeypatch):
    """One robust GL step (5 PGD iterations at the cifar10 config's eps and
    alpha, tau = 0, then an SGD step with momentum 0.9, weight decay 5e-4
    and the cosine LR) from carried weights, in float64, against the same
    step composed from JAX's make_gl_pgd_perturb_p, laplace_learning,
    custom_ce_loss and the optax chain.  PreAct at one block a stage, no
    dropout; 28x28 images, 3 base + 4 batch, 3 classes; the port's PGD
    starts from JAX's uniform draw.

    k = 5 keeps the 7-node graph connected through the attack.  With 16
    nodes at k = 5 the PGD steps cut batch images off from a class's base
    images; their scores for it are exactly 0 and their input gradients
    are rounding noise in both frameworks, which PGD's sign turns into
    different +-alpha steps (ROADMAP section 3)."""
    monkeypatch.setattr(jpreact, "jnp", _F64Numpy())
    f64, k, l = jnp.float64, 5, 3
    cfg = ad.DATASET_CONFIGS["cifar10"]
    jmodel = jpreact.PreActResNetFeat(jpreact.PreActBlock, (1, 1, 1, 1),
                                      feat_dim=16, num_classes=l, dtype=f64)
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 28, 28, 3), f64))

    def leaf(path, a):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith(("scale", "var")):
            return rng.uniform(0.5, 1.5, a.shape)
        if name.endswith("kernel"):
            return rng.normal(size=a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        return 0.1 * rng.normal(size=a.shape)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    params, stats = v["params"], v["batch_stats"]
    base = rng.uniform(-1.5, 1.5, (3, 28, 28, 3))
    base_y = np.arange(l)
    x = rng.uniform(-1.5, 1.5, (4, 28, 28, 3))
    y = rng.integers(0, l, 4)
    lo, hi = cfg.min_val.reshape(1, 1, 1, 3), cfg.max_val.reshape(1, 1, 1, 3)
    key = jax.random.PRNGKey(7)
    schedule = optax.cosine_decay_schedule(cfg.lr, 150 * 5)
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.trace(decay=0.9),
                     optax.scale_by_learning_rate(schedule))

    def apply_feats(p, bs, imgs):
        return jmodel.apply({"params": p, "batch_stats": bs}, imgs,
                            train=False)[1]

    perturb = jpgd(apply_feats, l, tau=0.0, k=k, eps=cfg.pgd_epsilon,
                   alpha=cfg.pgd_alpha, num_iters=cfg.pgd_iters)

    @jax.jit
    def jstep(p, bs, adv):
        def loss_fn(p):
            (_, feats), upd = jmodel.apply(
                {"params": p, "batch_stats": bs},
                jnp.concatenate([jnp.asarray(base), adv]), train=True,
                mutable=["batch_stats"])
            pred = jlaplace(feats, jax.nn.one_hot(base_y, l, dtype=f64),
                            tau=0.0, epsilon="auto", k=k)
            return jce(pred, jnp.asarray(y)), upd

        (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, optax.apply_updates(p, updates)

    jadv = perturb(params, stats, jnp.asarray(base), jnp.asarray(base_y),
                   jnp.asarray(x), jnp.asarray(y), key, lo, hi)
    jloss, jnew = jstep(params, stats, jadv)

    nchw = functools.partial(np.transpose, axes=(0, 3, 1, 2))
    model = PreActResNetFeat(PreActBlock, (1, 1, 1, 1), feat_dim=16,
                             num_classes=l).double()
    model.load_state_dict(params_from_jax(params, stats, model), strict=True)
    state = create_train_state(model, ad._make_schedule(cfg, 5),
                               device="cpu", **ad._make_tx(cfg, "gl"))
    op_kw = dict(tau=0.0, epsilon="auto", k=k)
    tbase, tx_, ty = (torch.tensor(nchw(base)), torch.tensor(nchw(x)),
                      torch.tensor(y))
    tbase_y = torch.tensor(base_y)
    tlo, thi = (torch.tensor(cfg.min_val, dtype=torch.float64),
                torch.tensor(cfg.max_val, dtype=torch.float64))
    noise = jax.random.uniform(key, x.shape, f64, -cfg.pgd_epsilon,
                               cfg.pgd_epsilon)
    start = torch.clamp(tx_ + torch.tensor(nchw(np.asarray(noise))), tlo, thi)
    loss_fn = gl_loss(lambda imgs: ad._eval_features(model, imgs), l, op_kw,
                      tbase, tbase_y, ty, [])
    adv = pgd_iterations(loss_fn, start, tx_, cfg.pgd_alpha,
                         cfg.pgd_epsilon, cfg.pgd_iters, tlo, thi)
    np.testing.assert_allclose(adv.numpy(), nchw(np.asarray(jadv)),
                               atol=1e-9, rtol=0)
    assert (adv - start).abs().max().item() >= cfg.pgd_alpha     # it moved
    loss, op_stats = ad._gl_train_step(state, l, op_kw, tbase, tbase_y, adv,
                                       ty)
    assert int(op_stats["chol_info"]) == 0
    assert abs(loss.item() - float(jloss)) <= 1e-8 * abs(float(jloss))
    want = params_from_jax(jnew, stats, model)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.detach().numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-8, (name, err)


def test_jax_driver_reuses_one_dropout_key(monkeypatch, tmp_path):
    """The JAX driver's train steps all draw dropout from PRNGKey(0), so
    SmallCNN's dropout mask is the same on every step; the port draws a
    fresh mask each step from its seeded generator."""
    monkeypatch.setitem(jad.DATASET_CONFIGS, "synthetic", _tiny(jad))
    monkeypatch.setattr(jad, "load_dataset",
                        functools.partial(jad.load_dataset, **TINY))
    keys = []
    apply = jad._apply

    def recording_apply(model, params, batch_stats, x, train, rng=None):
        if rng is not None:
            jax.debug.callback(lambda k: keys.append(np.asarray(k)), rng)
        return apply(model, params, batch_stats, x, train, rng)

    monkeypatch.setattr(jad, "_apply", recording_apply)
    jad.run("mlp", "natural", "synthetic", epochs=1,
            save_dir=str(tmp_path / "jax"))
    jax.effects_barrier()
    assert len(keys) == 4                         # 128 images / batch 32
    assert all(np.array_equal(k, np.asarray(jax.random.PRNGKey(0)))
               for k in keys)

    # the port: each train step's dropout draws from the driver's seeded
    # generator, whose state has moved on by the next step
    monkeypatch.setitem(ad.DATASET_CONFIGS, "synthetic", _tiny(ad))
    states = []
    forward = Dropout.forward

    def recording_forward(self, x):
        if self.training:
            states.append(self.generator.get_state().clone())
        return forward(self, x)

    monkeypatch.setattr(Dropout, "forward", recording_forward)
    ad.run("mlp", "natural", "synthetic", epochs=1,
           save_dir=str(tmp_path / "torch"), synth=TINY, device="cpu")
    assert len(states) == 4
    assert len({tuple(s.tolist()) for s in states}) == 4
