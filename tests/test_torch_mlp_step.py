"""The MLP branch of the port's trainer and ``evalx.test_network`` against
the JAX package's, from identical weights on identical uint8 batches.

A tiny encoder (one stride-2 conv, a mean pool and a dense layer, as in
tests/test_fullysup_driver.py) is patched into both packages' model
registries, and its flax weights are carried to the port by hand; the
heads follow BuildNet's names.  Both sides compute in float32: loss rtol
1e-5, parameters after the update atol 1e-6 (float32 rounding of the same
arithmetic); predictions and accuracies exactly.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from graphlearninglayer_tpu.evalx import harness as jharness
from graphlearninglayer_tpu.models import BuildNet as JBuildNet
from graphlearninglayer_tpu.models import buildnet as jbn
from graphlearninglayer_tpu.models import l2_normalize as jl2
from graphlearninglayer_tpu.train import optim as joptim
from graphlearninglayer_tpu.train import trainer as jtrainer
from graphlearninglayer_tpu_torch.data import CHANNEL_STATS
from graphlearninglayer_tpu_torch.evalx import harness as tharness
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.models import buildnet as tbn
from graphlearninglayer_tpu_torch.models import l2_normalize
from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                make_lr_schedule,
                                                make_mlp_eval_step,
                                                make_mlp_train_step,
                                                metrics_to_host)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU ops are tiny: one thread runs them faster, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NUM_CLASSES, K, TAU = 4, 5, 0.07
SCHEDULE = dict(learning_rate=0.05, epochs=5, steps_per_epoch=10)
NORM = CHANNEL_STATS["cifar10"]


class JTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        x = fnn.relu(fnn.Conv(8, (3, 3), strides=2, padding=1)(x))
        return jl2(fnn.Dense(16)(jnp.mean(x, axis=(1, 2))))


class TTiny(nn.Module):
    def __init__(self, in_channel: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_channel, 8, 3, stride=2, padding=1)
        self.dense = nn.Linear(8, 16)

    def forward(self, x):
        return l2_normalize(self.dense(torch.relu(self.conv(x))
                                       .mean(dim=(2, 3))))


def _carry(params):
    """The port's state_dict from the flax BuildNet(tiny) params."""
    t = lambda a: torch.tensor(np.asarray(a))
    enc = params["JTiny_0"]
    sd = {"encoder.conv.weight": t(np.transpose(enc["Conv_0"]["kernel"],
                                                (3, 2, 0, 1))),
          "encoder.conv.bias": t(enc["Conv_0"]["bias"]),
          "encoder.dense.weight": t(np.transpose(enc["Dense_0"]["kernel"])),
          "encoder.dense.bias": t(enc["Dense_0"]["bias"])}
    for name, key in (("head_0", "head.0"), ("head_1", "head.2"),
                      ("linear_0", "linear.0"), ("linear_1", "linear.2")):
        sd[f"{key}.weight"] = t(np.transpose(params[name]["kernel"]))
        sd[f"{key}.bias"] = t(params[name]["bias"])
    return sd


@pytest.fixture(scope="module")
def setup():
    mp = pytest.MonkeyPatch()
    mp.setitem(jbn.model_dict, "tiny",
               (lambda dtype=jnp.float32: JTiny(), 16))
    mp.setitem(tbn.model_dict, "tiny",
               (lambda in_channel=3: TTiny(in_channel), 16))
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (70, 8, 8, 3)).astype(np.uint8)
    labels = rng.integers(0, NUM_CLASSES, 70)
    jmodel = JBuildNet(name="tiny", head="mlp", feat_dim=8,
                       num_classes=NUM_CLASSES)
    tx = joptim.make_optimizer(joptim.make_lr_schedule(**SCHEDULE))
    # create_train_state's init, compiled once rather than run op by op
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda x: jmodel.init(
        {"params": key, "dropout": key}, x, train=False))(
            jnp.zeros((1, 8, 8, 3)))
    jstate = jtrainer.TrainState(variables["params"], {},
                                 jax.jit(tx.init)(variables["params"]),
                                 jnp.zeros((), jnp.int32))
    sd0 = _carry(jstate.params)

    def port_state():
        model = BuildNet("tiny", head="mlp", feat_dim=8,
                         num_classes=NUM_CLASSES)
        model.load_state_dict(sd0)
        return create_train_state(model, make_lr_schedule(**SCHEDULE),
                                  device="cpu")

    yield dict(imgs=imgs, labels=labels, jmodel=jmodel, tx=tx,
               jstate=jstate, port_state=port_state)
    mp.undo()


def test_mlp_train_and_eval_step_match_jax(setup):
    imgs, labels = setup["imgs"][:24], setup["labels"][:24]
    jstep = jtrainer.make_mlp_train_step(setup["jmodel"], setup["tx"],
                                         norm=NORM)
    jnew, jm = jstep(setup["jstate"], imgs, labels, jax.random.PRNGKey(1))
    jnew, jm2 = jstep(jnew, imgs[::-1], labels[::-1], jax.random.PRNGKey(2))

    state = setup["port_state"]()
    step = make_mlp_train_step(norm=NORM, device="cpu")
    state, m = step(state, imgs, labels)
    state, m2 = step(state, imgs[::-1], labels[::-1])
    assert state.step == 2
    for got, want in ((m, jm), (m2, jm2)):
        host = metrics_to_host(got)
        np.testing.assert_allclose(host["loss"], float(want["loss"]),
                                   rtol=1e-5)
        assert host["acc"] == pytest.approx(float(want["acc"]))
        assert host["params_finite"]
    # every parameter moved as in JAX, the aux classifier and the
    # projection head included
    got = state.model.state_dict()
    for key, want in _carry(jnew.params).items():
        np.testing.assert_allclose(got[key].numpy(), want.numpy(),
                                   atol=1e-6, err_msg=key)

    test = setup["imgs"][24:]
    want = np.asarray(jtrainer.make_mlp_eval_step(setup["jmodel"],
                                                  norm=NORM)(jnew, test))
    pred = make_mlp_eval_step(norm=NORM, device="cpu")(state, test)
    assert pred.dtype == torch.int64
    np.testing.assert_array_equal(pred.numpy(), want)


@pytest.mark.parametrize("predictor", ["GL", "MLP"])
@pytest.mark.parametrize("tail", ["exact", "pad"])
def test_test_network_matches_jax(setup, predictor, tail, capsys):
    imgs, labels = setup["imgs"], setup["labels"]
    base, base_l = imgs[:12], labels[:12]
    test, test_l = imgs[12:], labels[12:]       # 58 = 2 x 24 + a tail of 10
    kw = dict(tau=TAU, epsilon="auto", k=K, batch_size=24,
              predictor=predictor, norm=NORM, tail=tail)
    want = jharness.test_network(setup["jmodel"], setup["jstate"], base,
                                 base_l, test, test_l, NUM_CLASSES, **kw)
    got = tharness.test_network(setup["port_state"](), base, base_l, test,
                                test_l, NUM_CLASSES, device="cpu", **kw)
    assert got == want
    assert f"Accuracy for {predictor} predictor" in capsys.readouterr().out


def test_test_network_rejects_unknown_modes(setup):
    state = setup["port_state"]()
    args = (state, setup["imgs"][:4], setup["labels"][:4],
            setup["imgs"][4:8], setup["labels"][4:8], NUM_CLASSES, TAU)
    with pytest.raises(ValueError, match="tail"):
        tharness.test_network(*args, tail="drop", device="cpu")
    with pytest.raises(ValueError):
        tharness.test_network(*args, predictor="SVM", device="cpu")
