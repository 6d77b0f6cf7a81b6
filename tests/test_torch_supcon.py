"""The port's SupCon / SimCLR driver (``train/supcon.py``) on the CPU.

One SupCon and one SimCLR step from identical float64 weights must agree
with the JAX driver's update composed from its parts (``_apply``,
``sup_con_loss`` and the optax chain) and compiled as one program: loss and
parameters within 1e-8 relative.  The device path's views must pair up as
the host ``TwoCropBatchLoader``'s do (view v of image i is flat row
2i + v, the layout JAX's device path builds by interleaving), and both
paths must run and learn as tests/test_supcon_driver.py holds the JAX
driver to, from the JAX test's initial weights: with PyTorch's default
initialization this tiny encoder maps every image to nearly one feature,
where the loss sits at log(2B - 1) from the first step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearninglayer_tpu.config.cli import parse_option as jparse_option
from graphlearninglayer_tpu.data import device_aug as jdevice_aug
from graphlearninglayer_tpu.models import BuildNet as JBuildNet
from graphlearninglayer_tpu.models import buildnet as jbn
from graphlearninglayer_tpu.train import optim as joptim
from graphlearninglayer_tpu.train import supcon as jsupcon_driver
from graphlearninglayer_tpu.train import trainer as jtrainer
from graphlearninglayer_tpu.train.losses import sup_con_loss as jsupcon
from graphlearninglayer_tpu_torch.config.cli import parse_option
from graphlearninglayer_tpu_torch.data import (CHANNEL_STATS, Transform,
                                               TwoCropBatchLoader,
                                               normalize_batch)
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                make_lr_schedule, supcon)
from graphlearninglayer_tpu_torch.utils.checkpoint import restore_checkpoint
from tests import torch_tiny


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE, B = (8, 8, 3), 8
SCHEDULE = dict(learning_rate=0.05, epochs=5, steps_per_epoch=10)
NORM = CHANNEL_STATS["cifar10"]


@pytest.mark.parametrize("simclr", [False, True])
def test_supcon_step_matches_jax_composition(simclr, monkeypatch):
    torch_tiny.register(monkeypatch)
    monkeypatch.setattr(jbn, "jnp", torch_tiny.F64Numpy())
    rng = np.random.default_rng(10)
    views = rng.integers(0, 256, (2, B, 2, *SHAPE)).astype(np.uint8)
    labels = rng.integers(0, 3, (2, B))
    jmodel = JBuildNet(name="tinycnn", head="mlp", feat_dim=8,
                       num_classes=3)
    params = torch_tiny.flax_init(jmodel, SHAPE, seed=2, dtype=jnp.float64)
    tx = joptim.make_optimizer(joptim.make_lr_schedule(**SCHEDULE))

    @jax.jit
    def jstep(params, opt_state, flat, y):
        def loss_fn(p):
            (_, feats), _ = jtrainer._apply(jmodel, p, {}, flat, train=True)
            return jsupcon(feats.reshape(B, 2, -1), None if simclr else y,
                           temperature=0.07)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    model = BuildNet("tinycnn", head="mlp", feat_dim=8, num_classes=3)
    model.load_state_dict(torch_tiny.carry(params))
    state = create_train_state(model.double(), make_lr_schedule(**SCHEDULE),
                               device="cpu")
    step = supcon.make_supcon_step(0.07, simclr, norm=NORM, device="cpu")
    opt_state = tx.init(params)
    for v, y in zip(views, labels):
        flat = normalize_batch(v.reshape(2 * B, *SHAPE), *NORM)
        params, opt_state, jloss = jstep(params, opt_state, flat, y)
        state, loss = step(state, v, y)
        assert abs(loss.item() - float(jloss)) <= 1e-8 * abs(float(jloss))
    torch_tiny.assert_params_close(state.model, torch_tiny.carry(params),
                                   1e-8)


class _Tag:
    """A transform that marks each call's output in pixel (0, 0, 0) with
    the call's number, leaving the rest of the image as it is."""

    def __init__(self):
        self.calls = 0

    def __call__(self, images, generator=None):
        out = images.clone()
        out[:, 0, 0, 0] = self.calls
        self.calls += 1
        return out


def test_device_views_pair_as_the_host_loader(monkeypatch):
    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, (24, *SHAPE)).astype(np.uint8)
    labels = rng.integers(0, 3, 24)
    loader = TwoCropBatchLoader(images, labels, B, Transform("cifar10",
                                                             "weak"),
                                workers=0, emit="uint8", prefetch=0)
    tag = _Tag()
    monkeypatch.setattr(loader, "_augment_batch",
                        lambda batch, rng=None: tag(torch.from_numpy(
                            batch)).numpy())
    data = torch.from_numpy(images.reshape(24, -1))
    for idx, host_views, _ in loader:
        tag.calls = 0
        views = supcon.device_views(_Tag(), data, torch.from_numpy(idx),
                                    SHAPE)
        assert views.shape == (B, 2, *SHAPE) and views.dtype == torch.uint8
        np.testing.assert_array_equal(views.numpy(), host_views)
        for i in range(B):
            for v in range(2):
                want = images[idx[i]].copy()
                want[0, 0, 0] = v
                np.testing.assert_array_equal(views[i, v].numpy(), want)


class _ViewTag:
    """A DeviceTransform stand-in for both frameworks: the v-th call of a
    step (view v) writes v into each image's first pixel and leaves the
    rest as it is.  JAX traces its step once, so its two calls are 0
    and 1 in every step."""

    def __init__(self, *args, **kwargs):
        self.calls = 0

    def __call__(self, images, rng=None):
        v = self.calls % 2
        self.calls += 1
        if isinstance(images, torch.Tensor):
            out = images.clone()
            out[:, 0, 0, 0] = v
            return out
        return images.at[:, 0, 0, 0].set(v)


def test_device_path_feeds_the_model_as_jax_does(tiny_opt, monkeypatch):
    """Both drivers' --device_data runs, with the views tagged: the uint8
    rows each step feeds its model are equal, so the port pairs view v of
    image i at flat row 2i + v as JAX's view-major concatenate and
    interleave do, over the same order."""
    seen_jax, seen_port = [], []

    def jax_apply(model, params, stats, x, train, rng=None):
        jax.debug.callback(lambda a: seen_jax.append(np.asarray(a)), x)
        leaf = jax.tree_util.tree_leaves(params)[0]
        feats = x.reshape(x.shape[0], -1)[:, :16] / 255.0 \
            + 1e-3 * jnp.sum(leaf)
        return (None, feats), stats

    monkeypatch.setattr(jdevice_aug, "DeviceTransform", _ViewTag)
    monkeypatch.setattr(jsupcon_driver, "_device_normalize",
                        lambda x, norm: x.astype(jnp.float32))
    monkeypatch.setattr(jsupcon_driver, "_apply", jax_apply)
    monkeypatch.setattr(jsupcon_driver, "save_checkpoint",
                        lambda *a, **kw: None)
    # one scalar stands in for the encoder's parameters
    monkeypatch.setattr(
        jsupcon_driver, "create_train_state",
        lambda model, tx, rng, x: jtrainer.TrainState(
            jnp.ones(()), {}, tx.init(jnp.ones(())), jnp.zeros((), int)))
    argv = tiny_opt + ["--device_data", "--epochs", "1"]
    jsupcon_driver.run_supcon(jparse_option(argv[2:]))

    normalize = supcon._device_normalize

    def port_normalize(x, norm):
        seen_port.append(x.clone())
        return normalize(x, norm)

    monkeypatch.setattr(supcon, "DeviceTransform", _ViewTag)
    monkeypatch.setattr(supcon, "_device_normalize", port_normalize)
    monkeypatch.setattr(supcon, "save_checkpoint", lambda *a, **kw: None)
    supcon.main(argv)

    assert len(seen_jax) == len(seen_port) == 3
    for want, got in zip(seen_jax, seen_port):
        assert got.shape == (64, 28, 28, 1) and got.dtype == torch.uint8
        np.testing.assert_array_equal(got[:, 0, 0, 0].numpy(),
                                      np.tile([0, 1], 32))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


@pytest.fixture(scope="module")
def flax_start():
    """The flax BuildNet(tinycnn)'s initial weights for 28x28x1 images, as
    the port's state_dict."""
    mp = pytest.MonkeyPatch()
    torch_tiny.register(mp)
    jmodel = JBuildNet(name="tinycnn", head="mlp", feat_dim=128,
                       num_classes=10)
    yield torch_tiny.carry(torch_tiny.flax_init(jmodel, (28, 28, 1)),
                           torch.float32)
    mp.undo()


@pytest.fixture()
def tiny_opt(tmp_path, monkeypatch, flax_start):
    """The JAX driver test's config, starting from its flax encoder's
    initial weights (tinycnn, mlp head, 28x28x1 synthetic data)."""
    torch_tiny.register(monkeypatch)
    sd = flax_start
    build = supcon.BuildNet

    def flax_started(*a, **kw):
        model = build(*a, **kw)
        model.load_state_dict(sd)
        return model

    monkeypatch.setattr(supcon, "BuildNet", flax_started)
    monkeypatch.chdir(tmp_path)
    return ["--dev", "cpu", "--dataset", "synthetic", "--model", "tinycnn",
            "--epochs", "3", "--batch_size", "32", "--synth_n_train", "96",
            "--synth_n_test", "32", "--num_workers", "0",
            "--sup_method", "SupCon", "--augment_type_ss", "weak"]


def test_both_paths_run_learn_and_checkpoint(tiny_opt):
    for extra in ([], ["--device_data"]):
        opt = parse_option(tiny_opt + extra)
        rec = supcon.main(tiny_opt + extra)
        assert len(rec["loss"]) == 3 and all(np.isfinite(rec["loss"]))
        assert rec["loss"][-1] < rec["loss"][0], (extra, rec["loss"])
        model = BuildNet("tinycnn", num_classes=10, in_channel=1)
        state = create_train_state(model, make_lr_schedule(0.1, 1, 1),
                                   device="cpu")
        state, epoch = restore_checkpoint(f"{opt.save_folder}/supcon",
                                          state)
        assert epoch == 3 and state.step == 9
    # any --sup_method but SupCon trains SimCLR
    rec = supcon.main(tiny_opt + ["--device_data", "--epochs", "1",
                                  "--sup_method", "SupCE"])
    assert len(rec["loss"]) == 1 and np.isfinite(rec["loss"][0])


def test_main_raises_without_cuda_unless_dev_cpu(tiny_opt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--dev cpu"):
        supcon.main([a for a in tiny_opt if a not in ("--dev", "cpu")])
