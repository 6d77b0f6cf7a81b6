"""A tiny encoder in both frameworks, for the port's driver tests.

One stride-2 conv, a mean pool and a dense layer to 16 features, as in
tests/test_fullysup_driver.py; ``register`` patches it into both packages'
model registries as ``tinycnn``, and ``carry`` maps the flax BuildNet's
parameters onto the port's BuildNet (mlp head, aux classifier).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn as nn

from graphlearninglayer_tpu.models import buildnet as jbn
from graphlearninglayer_tpu.models import l2_normalize as jl2
from graphlearninglayer_tpu_torch.models import buildnet as tbn
from tests.torch_ranks import TTiny


class JTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        x = fnn.relu(fnn.Conv(8, (3, 3), strides=2, padding=1)(x))
        return jl2(fnn.Dense(16)(jnp.mean(x, axis=(1, 2))))


class F64Numpy:
    """jax.numpy with ``float32`` read as float64: the flax BuildNet casts
    its encoder's features to float32, which would cut a float64
    comparison."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def register(monkeypatch, name: str = "tinycnn") -> None:
    monkeypatch.setitem(jbn.model_dict, name,
                        (lambda dtype=jnp.float32: JTiny(), 16))
    monkeypatch.setitem(tbn.model_dict, name,
                        (lambda in_channel=3: TTiny(in_channel), 16))


def flax_init(jmodel, image_shape, seed: int = 0, dtype=jnp.float32):
    """The flax model's initial parameters (one compiled init), cast to
    ``dtype``."""
    key = jax.random.PRNGKey(seed)
    params = jax.jit(lambda x: jmodel.init(
        {"params": key, "dropout": key}, x, train=False))(
            jnp.zeros((1, *image_shape)))["params"]
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), params)


def carry(params, dtype=torch.float64) -> dict:
    """The port BuildNet's state_dict from a flax BuildNet(tinycnn, mlp
    head) parameter tree."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
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


def assert_params_close(model: nn.Module, want: dict, rtol: float) -> None:
    """Every parameter of ``model`` within ``rtol`` of ``want``'s, relative
    to the largest entry of the tensor (absolute for an all-zero one)."""
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.detach().numpy() - w).max() / (np.abs(w).max() or 1.0)
        assert err <= rtol, (name, err)
