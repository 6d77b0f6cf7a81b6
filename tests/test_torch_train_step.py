"""The whole slice: one GL train step and one GL eval step of the port
against the JAX package's, from identical weights on identical uint8 NHWC
batches (ResNet-18 + mlp head, 8x8x3 images, 8 base + 24 batch, 4 classes,
k=5, tau=0.07, eps auto, SGD with cosine schedule).

Both sides compute in float32.  The images are uniform random bytes: on the
smooth synthetic images at 8x8 the float32 gradient of the freshly
initialised ResNet-18 is itself ill-conditioned (each framework's float32
gradient differs from a float64 gradient by up to 5% in layers 1-3), while
on random bytes both agree with float64 to ~2e-5.  Tolerances: loss and
scores rtol 1e-5 (float32 through 18 conv layers and the graph solve);
parameters and BN running means after the update atol 1e-6, running
variances after torch's unbiased-variance factor N/(N-1); the update
itself (new - old, i.e. lr * (grad + wd * param)) to 1e-4 of its largest entry per tensor, plus two
float32 ulps of the parameter, at whose scale new - old is rounded.  The
seed is one of the well-conditioned draws: for about one draw in three a
ReLU or neighbor decision sits within float32 rounding of its threshold,
and then either framework's float32 gradient is off from float64 by up to
8%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.models import BuildNet as JBuildNet
from graphlearninglayer_tpu.train import optim as joptim
from graphlearninglayer_tpu.train import trainer as jtrainer
from graphlearninglayer_tpu_torch.data import CHANNEL_STATS
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                make_gl_eval_step,
                                                make_gl_train_step,
                                                make_lr_schedule,
                                                metrics_to_host)
from graphlearninglayer_tpu_torch.utils import params_from_jax


NUM_CLASSES, K, TAU = 4, 5, 0.07
SCHEDULE = dict(learning_rate=0.01, epochs=5, steps_per_epoch=10)
NORM = CHANNEL_STATS["cifar10"]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (56, 8, 8, 3)).astype(np.uint8)
    labels = rng.integers(0, NUM_CLASSES, 56)
    batch = (imgs[:8], labels[:8], imgs[8:32], labels[8:32])
    test = imgs[32:]

    jmodel = JBuildNet(name="resnet18", head="mlp", feat_dim=128,
                       num_classes=NUM_CLASSES)
    tx = joptim.make_optimizer(joptim.make_lr_schedule(**SCHEDULE))
    jstate = jtrainer.create_train_state(jmodel, tx, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 8, 8, 3)))
    sd0 = params_from_jax(jstate.params, jstate.batch_stats)

    def port_state():
        model = BuildNet("resnet18", head="mlp", feat_dim=128,
                         num_classes=NUM_CLASSES)
        model.load_state_dict(sd0)
        return create_train_state(model, make_lr_schedule(**SCHEDULE),
                                  device="cpu")

    return dict(batch=batch, test=test, jmodel=jmodel, tx=tx, jstate=jstate,
                sd0=sd0, port_state=port_state)


def test_gl_train_step_matches_jax(setup):
    base, base_l, imgs, lbls = setup["batch"]
    jstep = jtrainer.make_gl_train_step(setup["jmodel"], setup["tx"],
                                        NUM_CLASSES, tau=TAU, epsilon="auto",
                                        k=K, norm=NORM)
    jnew, jm, jscores = jstep(setup["jstate"], base, base_l, imgs, lbls,
                              jax.random.PRNGKey(1))

    state = setup["port_state"]()
    step = make_gl_train_step(NUM_CLASSES, tau=TAU, epsilon="auto", k=K,
                              norm=NORM, device="cpu")
    state, metrics, scores = step(state, base, base_l, imgs, lbls)
    assert state.step == 1
    assert all(isinstance(v, torch.Tensor) for v in metrics.values())
    host = metrics_to_host(metrics)
    assert host["params_finite"] and host["chol_info"] == 0

    np.testing.assert_allclose(host["loss"], float(jm["loss"]), rtol=1e-5)
    assert host["acc"] == pytest.approx(float(jm["acc"]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-5)

    sd1 = params_from_jax(jnew.params, jnew.batch_stats)
    got = state.model.state_dict()
    sd0 = setup["sd0"]
    checked = 0
    for key, want in sd1.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith("running_var"):
            # torch updates running_var with the unbiased batch variance,
            # flax with the biased one; N = B*H*W at the layer (32 images,
            # 8x8 at the stem and layer1, halved by each later stage)
            stage = int(key.split(".")[1][5:]) if ".layer" in key else 1
            n = 32 * (8 >> (stage - 1)) ** 2
            old = sd0[key].numpy()
            want = 0.9 * old + (want.numpy() - 0.9 * old) * n / (n - 1)
            np.testing.assert_allclose(got[key].numpy(), want, atol=2e-5,
                                       rtol=1e-4, err_msg=key)
            checked += 1
            continue
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), atol=1e-6,
                                   err_msg=key)
        if not key.endswith("running_mean"):
            delta_t = (got[key] - sd0[key]).numpy()
            delta_j = (want - sd0[key]).numpy()
            scale = np.abs(delta_j).max()
            ulp = np.spacing(np.abs(sd0[key].numpy()).max())
            np.testing.assert_allclose(delta_t, delta_j,
                                       atol=1e-4 * scale + 2 * ulp,
                                       err_msg=key)
        checked += 1
    assert checked == len(list(state.model.parameters())) + 2 * 20


def test_gl_eval_step_matches_jax(setup):
    base, base_l, _, _ = setup["batch"]
    test = setup["test"]
    jeval = jtrainer.make_gl_eval_step(setup["jmodel"], NUM_CLASSES, tau=TAU,
                                       k=K, norm=NORM)
    want = np.asarray(jeval(setup["jstate"], base, base_l, test))
    state = setup["port_state"]()
    got = make_gl_eval_step(NUM_CLASSES, tau=TAU, k=K, norm=NORM,
                            device="cpu")(state, base, base_l, test)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
