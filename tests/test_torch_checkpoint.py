"""The port's checkpoints (``utils/checkpoint.py``).

* A save/restore round trip brings back the weights, the optimizer's
  momentum, the step and the LR schedule's position; re-saving an epoch
  overwrites it; a missing path raises.
* A checkpoint in the reference's torch layout (``module.`` prefixes, a
  missing tensor, an extra one, one of the wrong shape) loads tolerantly and
  reports the same missing and unexpected keys as the JAX package's
  ``convert_torch_state_dict`` on the same state_dict (its flax paths mapped
  to the port's names through ``params_from_jax``).
"""
import argparse
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.models import BuildNet as JBuildNet
from graphlearninglayer_tpu.utils.torch_import import convert_torch_state_dict
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                make_lr_schedule)
from graphlearninglayer_tpu_torch.utils import (latest_step,
                                                load_state_dict_tolerant,
                                                params_from_jax,
                                                restore_checkpoint,
                                                save_checkpoint)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU ops are tiny: one thread runs them faster, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Tiny(torch.nn.Module):
    def __init__(self, in_channel: int = 3):
        super().__init__()
        self.conv = torch.nn.Conv2d(in_channel, 8, 3, stride=2, padding=1)
        self.bn = torch.nn.BatchNorm2d(8)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x))).mean(dim=(2, 3))


def _state(seed, head="linear", name="resnet18"):
    model = BuildNet(name, head=head, feat_dim=16, num_classes=4,
                     generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, make_lr_schedule(0.1, 4, 5),
                              device="cpu")


def _take_steps(state, n):
    x = torch.randn(6, 3, 8, 8, generator=torch.Generator().manual_seed(1))
    for _ in range(n):
        state.model.train()
        pred, feat = state.model(x)
        loss = pred.sum() + feat.sum()
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1


def test_round_trip_overwrite_and_missing_path(tmp_path, capsys,
                                               monkeypatch):
    # a small encoder with BatchNorm: the round trip needs no ResNet
    from graphlearninglayer_tpu_torch.models import buildnet

    monkeypatch.setitem(buildnet.model_dict, "tiny",
                        (lambda in_channel=3: _Tiny(in_channel), 8))
    _state = functools.partial(globals()["_state"], name="tiny")
    state = _state(0)
    _take_steps(state, 3)
    path = str(tmp_path / "ckpt")
    opt = argparse.Namespace(learning_rate=0.1, lr_decay_epochs=[3, 4])
    save_checkpoint(path, state, 1, opt)
    save_checkpoint(path, state, 2, opt)
    assert latest_step(path) == 2
    payload = torch.load(os.path.join(path, "ckpt_epoch_2.pth"),
                         weights_only=True)
    assert set(payload) == {"opt", "model", "optimizer", "epoch", "step"}
    assert payload["opt"]["lr_decay_epochs"] == [3, 4]

    fresh = _state(1)
    fresh, epoch = restore_checkpoint(path, fresh)
    assert epoch == 2 and fresh.step == 3
    assert "Missing keys" not in capsys.readouterr().out
    for key, want in state.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[key], want,
                                   rtol=0, atol=0)
    assert fresh.scheduler.get_last_lr() == state.scheduler.get_last_lr()
    mom = [fresh.optimizer.state[p]["momentum_buffer"]
           for p in fresh.model.parameters()]
    want = [state.optimizer.state[p]["momentum_buffer"]
            for p in state.model.parameters()]
    for a, b in zip(mom, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the next update of the restored state equals the original's
    _take_steps(state, 1)
    _take_steps(fresh, 1)
    for a, b in zip(fresh.model.parameters(), state.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    # re-saving an epoch overwrites it, leaving no temporary file
    save_checkpoint(path, fresh, 2, opt)
    assert sorted(os.listdir(path)) == ["ckpt_epoch_1.pth",
                                        "ckpt_epoch_2.pth"]
    _, epoch = restore_checkpoint(path, _state(2), epoch=1)
    assert epoch == 1
    assert restore_checkpoint(path, _state(2))[0].step == 4
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nowhere"), _state(2))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(path, _state(2), epoch=5)


def _flax_names(params, batch_stats):
    """{port state_dict key: flax path string}, through params_from_jax on
    trees whose leaves carry their own ids."""
    paths = []

    def tag(col):
        def f(path, leaf):
            paths.append("/".join(str(getattr(k, "key", k)) for k in path))
            return np.full(np.shape(leaf), len(paths) - 1, np.float32)
        return f

    p = jax.tree_util.tree_map_with_path(tag("params"), params)
    b = jax.tree_util.tree_map_with_path(tag("batch_stats"), batch_stats)
    sd = params_from_jax(p, b)
    return {k: paths[int(v.reshape(-1)[0])] for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def test_reference_layout_reports_match_jax(tmp_path, capsys):
    jmodel = JBuildNet(name="resnet18", head="mlp", feat_dim=16,
                       num_classes=4)
    # the templates' shapes are all the conversion reads: no real init
    shapes = jax.eval_shape(
        lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(0)}, x,
                              train=False), jnp.zeros((1, 8, 8, 3)))
    variables = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)
    jparams, jstats = variables["params"], variables["batch_stats"]

    ref = _state(3, head="mlp").model.state_dict()
    sd = {f"module.{k}": v.clone() for k, v in ref.items()}
    del sd["module.head.0.weight"]
    del sd["module.encoder.layer2.1.bn1.running_var"]
    sd["module.extra.weight"] = torch.zeros(3)
    sd["module.linear.2.bias"] = torch.zeros(7)

    _, _, want = convert_torch_state_dict(sd, jparams, jstats, verbose=False)
    state = _state(4, head="mlp")
    got = load_state_dict_tolerant(state.model, sd)
    out = capsys.readouterr().out
    assert "Missing keys:" in out and "Unexpected keys:" in out
    assert sorted(got["unexpected"]) == sorted(want["unexpected"]) == [
        "extra.weight", "linear.2.bias"]
    names = _flax_names(jparams, jstats)
    assert sorted(names[k] for k in got["missing"]) == sorted(
        want["missing"])
    assert len(got["missing"]) == 3
    loaded = state.model.state_dict()
    torch.testing.assert_close(loaded["encoder.conv1.weight"],
                               ref["encoder.conv1.weight"])

    # a reference .pth file (argparse options pickled in) restores weights
    # only, with the epoch it records
    file = tmp_path / "ref.pth"
    torch.save({"opt": argparse.Namespace(model="resnet18"), "model": sd,
                "optimizer": {}, "epoch": 7}, file)
    state, epoch = restore_checkpoint(str(file), _state(5, head="mlp"))
    assert epoch == 7 and state.step == 0
    assert "torch import:" in capsys.readouterr().out
    torch.testing.assert_close(state.model.state_dict()["linear.0.weight"],
                               ref["linear.0.weight"])
