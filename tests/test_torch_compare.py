"""The port's MLP-vs-GL comparison driver (``train/compare_to_mlp.py``) on
the CPU.

One compare step from identical float64 weights must agree with the step
of the JAX driver composed from its parts (``_apply``, ``laplace_learning``
and ``custom_ce_loss`` on the parameters before the update, the MLP head's
update through the optax chain), compiled as one program: both losses and
the updated parameters within 1e-8 relative.  The batch reaches the JAX
program normalized, as the port normalizes it (inside a compiled program
XLA's float32 normalization differs by an ulp).  The driver itself must
train only the MLP head while its GL meter reads another head, as
tests/test_compare_driver.py holds the JAX driver to.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearninglayer_tpu.models import BuildNet as JBuildNet
from graphlearninglayer_tpu.models import buildnet as jbn
from graphlearninglayer_tpu.ops import laplace_learning as jlaplace
from graphlearninglayer_tpu.train import optim as joptim
from graphlearninglayer_tpu.train import trainer as jtrainer
from graphlearninglayer_tpu.train.losses import custom_ce_loss as jce
from graphlearninglayer_tpu_torch.config.cli import parse_option
from graphlearninglayer_tpu_torch.data import CHANNEL_STATS, normalize_batch
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.train import (compare_to_mlp,
                                                create_train_state,
                                                make_lr_schedule)
from tests import torch_tiny


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L, K, TAU, SHAPE = 4, 5, 0.07, (8, 8, 3)
SCHEDULE = dict(learning_rate=0.05, epochs=5, steps_per_epoch=10)
NORM = CHANNEL_STATS["cifar10"]


def test_compare_step_matches_jax_composition(monkeypatch):
    torch_tiny.register(monkeypatch)
    monkeypatch.setattr(jbn, "jnp", torch_tiny.F64Numpy())
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (40, *SHAPE)).astype(np.uint8)
    labels = rng.integers(0, L, 40)
    base_x = normalize_batch(images[:8], *NORM)
    base_y = np.arange(8) % L
    jmodel = JBuildNet(name="tinycnn", head="mlp", feat_dim=8,
                       num_classes=L)
    params = torch_tiny.flax_init(jmodel, SHAPE, seed=1, dtype=jnp.float64)
    tx = joptim.make_optimizer(joptim.make_lr_schedule(**SCHEDULE))

    @jax.jit
    def jstep(params, opt_state, x, y):
        def loss_fn(p):
            (pred, _), _ = jtrainer._apply(jmodel, p, {}, x, train=True)
            return jce(pred, y)

        mlp_loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        new = optax.apply_updates(params, updates)
        (_, feats), _ = jtrainer._apply(
            jmodel, params, {}, jnp.concatenate([jnp.asarray(base_x), x]),
            train=False)
        gl_pred = jlaplace(feats, jax.nn.one_hot(base_y, L,
                                                 dtype=feats.dtype),
                           tau=TAU, epsilon="auto", k=K)
        return new, opt_state, mlp_loss, jce(gl_pred, y)

    model = BuildNet("tinycnn", head="mlp", feat_dim=8, num_classes=L)
    model.load_state_dict(torch_tiny.carry(params))
    state = create_train_state(model.double(), make_lr_schedule(**SCHEDULE),
                               device="cpu")
    step = compare_to_mlp.make_compare_step(L, base_x, base_y, tau=TAU, k=K,
                                            norm=NORM, device="cpu")
    opt_state = tx.init(params)
    for rows in (slice(8, 24), slice(24, 40)):
        params, opt_state, jmlp, jgl = jstep(
            params, opt_state, normalize_batch(images[rows], *NORM),
            labels[rows])
        state, mlp_loss, gl_loss = step(state, images[rows], labels[rows])
        for got, want in ((mlp_loss, jmlp), (gl_loss, jgl)):
            assert abs(got.item() - float(want)) <= 1e-8 * abs(float(want))
        assert abs(gl_loss.item() - mlp_loss.item()) > 1e-3
    torch_tiny.assert_params_close(state.model, torch_tiny.carry(params),
                                   1e-8)


@pytest.fixture()
def tiny_opt(tmp_path, monkeypatch):
    torch_tiny.register(monkeypatch)
    monkeypatch.chdir(tmp_path)
    return ["--dev", "cpu", "--dataset", "synthetic", "--model", "tinycnn",
            "--epochs", "3", "--batch_size", "32", "--num_train", "12",
            "--knn_k", "6", "--synth_n_train", "96", "--synth_n_test", "32",
            "--num_workers", "0", "--epsilon", "auto",
            "--learning_rate", "0.05"]


def test_dual_meters_diverge_and_gl_head_is_not_trained(tiny_opt,
                                                        monkeypatch):
    opt = parse_option(tiny_opt)
    rec = compare_to_mlp.run_comparison(opt)
    assert len(rec["mlp_loss"]) == 3 == len(rec["gl_loss"])
    assert all(np.isfinite(rec["mlp_loss"] + rec["gl_loss"]))
    # the meters read different heads on the same batches
    assert any(abs(m - g) > 1e-3
               for m, g in zip(rec["mlp_loss"], rec["gl_loss"]))
    assert rec["mlp_loss"][-1] < rec["mlp_loss"][0]
    saved = np.load(os.path.join(opt.save_folder, "compare_records.npy"),
                    allow_pickle=True).item()
    assert saved["gl_loss"] == rec["gl_loss"]

    # the GL forward feeds no gradient: with it spied on (and so really
    # run, without autograd), the MLP head trains exactly as without
    rec1 = compare_to_mlp.run_comparison(parse_option(tiny_opt
                                                      + ["--epochs", "1"]))
    calls = []
    orig = compare_to_mlp.laplace_learning

    def spy(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return orig(*a, **kw)

    monkeypatch.setattr(compare_to_mlp, "laplace_learning", spy)
    rec2 = compare_to_mlp.run_comparison(parse_option(tiny_opt
                                                      + ["--epochs", "1"]))
    assert calls == [False] * 3                  # 3 steps, no autograd
    assert rec2["mlp_loss"] == rec1["mlp_loss"]


def test_main_raises_without_cuda_unless_dev_cpu(tiny_opt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--dev cpu"):
        compare_to_mlp.main([a for a in tiny_opt if a not in ("--dev",
                                                               "cpu")])
    rec = compare_to_mlp.main(tiny_opt + ["--epochs", "1"])
    assert rec["steps_per_epoch"] == 3 and len(rec["epoch_s"]) == 1
