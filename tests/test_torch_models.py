"""The port's BuildNet (``models/``) against the JAX BuildNet.

Weights go from the JAX model to the port through ``utils.params_from_jax``;
inputs are the same numpy batch, NHWC for JAX and NCHW for the port.  The
bar is atol 2e-4, as in tests/test_torch_import.py: float32 on both sides
through 18 convolution layers, summed in different orders.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.models import BuildNet as JBuildNet
from graphlearninglayer_tpu.utils.torch_import import convert_torch_state_dict
from graphlearninglayer_tpu_torch.models import BuildNet, l2_normalize
from graphlearninglayer_tpu_torch.utils import params_from_jax


def _jax_model(head, rng):
    """JAX BuildNet with randomized BN affine params and running stats, so
    that every BN leaf is carried across and exercised."""
    model = JBuildNet(name="resnet18", head=head, feat_dim=128,
                      num_classes=10)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                   train=False)

    def bn_leaf(path, leaf):
        name = str(path[-1])
        if "scale" in name or "var" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "BatchNorm" in str(path[-2]):
            return (0.2 * rng.normal(size=leaf.shape)).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(bn_leaf, v["params"])
    stats = jax.tree_util.tree_map_with_path(bn_leaf, v["batch_stats"])
    return model, params, stats


def _bn_sizes(tmodel):
    """{state_dict prefix of each BatchNorm2d: N = B*H*W of its input},
    filled by one forward pass."""
    sizes, hooks = {}, []
    for name, m in tmodel.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(
                functools.partial(
                    lambda nm, mod, inp, out: sizes.__setitem__(
                        nm, inp[0].shape[0] * inp[0].shape[2]
                        * inp[0].shape[3]), name)))
    return sizes, hooks


@pytest.mark.parametrize("head", ["mlp", "linear"])
def test_buildnet_matches_jax(rng, head):
    model, params, stats = _jax_model(head, rng)
    tmodel = BuildNet("resnet18", head=head, feat_dim=128, num_classes=10)
    tmodel.load_state_dict(params_from_jax(params, stats))
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    xt = torch.tensor(x.transpose(0, 3, 1, 2))

    # eval mode: running statistics
    jpred, jfeat = jax.jit(functools.partial(model.apply, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    tmodel.eval()
    with torch.no_grad():
        tpred, tfeat = tmodel(xt)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), atol=2e-4)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=2e-4)

    # train mode: batch statistics, and one update of the running stats
    (jpred, jfeat), upd = jax.jit(functools.partial(
        model.apply, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    sizes, hooks = _bn_sizes(tmodel)
    tmodel.train()
    with torch.no_grad():
        tpred, tfeat = tmodel(xt)
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), atol=2e-4)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=2e-4)

    before = params_from_jax(params, stats)
    after = params_from_jax(params, upd["batch_stats"])
    tsd = tmodel.state_dict()
    assert len(sizes) == 20
    for prefix, n in sizes.items():
        key = f"encoder.{prefix}" if not prefix.startswith("encoder") \
            else prefix
        np.testing.assert_allclose(tsd[key + ".running_mean"].numpy(),
                                   after[key + ".running_mean"].numpy(),
                                   atol=2e-5)
        # torch updates running_var with the UNBIASED batch variance, flax
        # with the biased one: new = 0.9 old + 0.1 var.  Scale flax's batch
        # variance by N / (N - 1), N = B*H*W at this layer.
        old = before[key + ".running_var"].numpy()
        flax_batch_var = after[key + ".running_var"].numpy() - 0.9 * old
        want = 0.9 * old + flax_batch_var * n / (n - 1)
        np.testing.assert_allclose(tsd[key + ".running_var"].numpy(), want,
                                   atol=2e-5, rtol=1e-4)


def test_params_from_jax_round_trip(rng):
    """params_from_jax, then the JAX package's own torch importer, gives
    back the original trees exactly."""
    _, params, stats = _jax_model("mlp", rng)
    sd = params_from_jax(params, stats)
    zeros = functools.partial(jax.tree_util.tree_map,
                              lambda a: np.zeros_like(np.asarray(a)))
    p2, s2, report = convert_torch_state_dict(sd, zeros(params), zeros(stats),
                                              verbose=False)
    assert report["missing"] == [] and report["unexpected"] == []
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(stats),
                    jax.tree_util.tree_leaves(s2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_encoder_keeps_head_and_features_f32(rng):
    torch.manual_seed(0)
    f32 = BuildNet("resnet18", head="mlp").eval()
    bf16 = BuildNet("resnet18", head="mlp", dtype=torch.bfloat16).eval()
    bf16.load_state_dict(f32.state_dict())
    x = torch.tensor(rng.normal(size=(2, 3, 16, 16)), dtype=torch.float32)
    with torch.no_grad():
        pred32, feat32 = f32(x)
        pred16, feat16 = bf16(x)
    assert feat16.dtype == torch.float32 and pred16.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert (feat16 - feat32).abs().max() < 5e-2  # bf16 keeps ~3 digits
    assert (feat16 - feat32).abs().max() > 0     # the encoder did run bf16


def test_l2_normalize_matches_jax_including_zero_rows(rng):
    """Values and gradients agree with the JAX l2_normalize, and a zero row
    gets a finite gradient (1/eps per entry), not NaN."""
    from graphlearninglayer_tpu.models.cnn import l2_normalize as jax_l2n

    x = rng.normal(size=(4, 6))
    x[1] = 0.0
    w = rng.normal(size=(4, 6))
    xt = torch.tensor(x, requires_grad=True)
    out = l2_normalize(xt)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax_l2n(jnp.asarray(x))),
                               atol=1e-12)
    want = jax.grad(lambda a: jnp.sum(jax_l2n(a) * w))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-12)
    assert np.all(np.isfinite(xt.grad.numpy()))
