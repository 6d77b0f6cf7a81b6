"""The port's entry points (``graphlearninglayer_tpu_torch/entry.py``)
against ``__graft_entry__.py``.

``entry()`` at a small shape (30 base + 30 batch nodes, float64; k = 25 as
at the flagship shape)
against the JAX flagship forward built the same way (BuildNet resnet18 with
an mlp head and 128-d features, then ``laplace_learning`` with tau 0.07
and eps auto), compiled as one ``jax.jit`` program: the flax shapes come
from ``jax.eval_shape``, the weights from numpy draws carried to the port
by ``params_from_jax``, the images from the port's own arguments.

The JAX flagship's encoder computes in float32 (BuildNet's default compute
dtype; its ResNet also pools, and BuildNet casts, the features in float32
whatever that dtype: ``models/resnet.py:60-63``, ``models/buildnet.py:56``),
while the port's BuildNet keeps the model's dtype.  So the encoder's pooled
output is held to the JAX one within float32's error (1e-5 of its largest
entry), and the rest of the forward (head, normalization, the graph head)
within 1e-8 on the JAX encoder's output, which stands in for the port's
encoder.  The whole forward, the port's float64 encoder included, lands
within 1e-5 of the JAX scores.

Then ``dryrun_multichip(2, device="cpu")`` on two gloo CPU ranks, as
tests/test_sharding.py runs the JAX dry run on eight virtual devices: it
passes, and the ranks' output holds no "exploding gradient".
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from graphlearninglayer_tpu.models import BuildNet as JBuildNet
from graphlearninglayer_tpu.ops import laplace_learning as jlaplace
from graphlearninglayer_tpu_torch.entry import dryrun_multichip, entry
from graphlearninglayer_tpu_torch.utils import params_from_jax

BASE, BATCH, K, CLASSES = 30, 30, 25, 10


class _Fixed(torch.nn.Module):
    """An encoder that returns given features."""

    def __init__(self, out: torch.Tensor):
        super().__init__()
        self.out = out

    def forward(self, x):
        return self.out


def _draw(rng, path, leaf):
    """A float64 value for a flax leaf: He-scaled kernels, small biases,
    BatchNorm affine parameters and running statistics away from their
    initial values, so every leaf is carried across and exercised."""
    name, shape = str(path[-1]), leaf.shape
    if "kernel" in name:
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(size=shape) * np.sqrt(2.0 / fan_in)
    if "scale" in name or "var" in name:
        return rng.uniform(0.5, 1.5, shape)
    return 0.2 * rng.normal(size=shape)


def test_entry_matches_jax_flagship_forward(rng):
    forward, (model, images, base_labels) = entry(
        device="cpu", base_n=BASE, batch_n=BATCH, num_classes=CLASSES,
        dtype=torch.float64)
    assert images.shape == (BASE + BATCH, 3, 32, 32)
    assert images.dtype == torch.float64 and not model.training
    assert base_labels.tolist() == list(range(CLASSES)) * (BASE // CLASSES)

    jmodel = JBuildNet(name="resnet18", head="mlp", feat_dim=128,
                       num_classes=CLASSES)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float64),
                            train=False))
    variables = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(rng, p, leaf), shapes)
    model.load_state_dict(params_from_jax(variables["params"],
                                          variables["batch_stats"]))

    @jax.jit
    def jforward(variables, images, base_labels):
        (_, feats), inter = jmodel.apply(variables, images, train=False,
                                         capture_intermediates=True)
        y = jax.nn.one_hot(base_labels, CLASSES, dtype=feats.dtype)
        return (jlaplace(feats, y, tau=0.07, epsilon="auto", k=K),
                inter["intermediates"]["ResNet_0"]["__call__"][0])

    want, jenc = (np.asarray(a) for a in jforward(
        variables, jnp.asarray(images.numpy().transpose(0, 2, 3, 1)),
        jnp.asarray(base_labels.numpy())))
    seen = []
    hook = model.encoder.register_forward_hook(
        lambda m, i, o: seen.append(o.numpy()))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = forward(model, images, base_labels).numpy()
        hook.remove()
        encoder, model.encoder = model.encoder, _Fixed(
            torch.tensor(jenc, dtype=torch.float64))
        got = forward(model, images, base_labels).numpy()
        model.encoder = encoder
    finally:
        torch.set_num_threads(n)
    (enc,) = seen
    assert jenc.dtype == np.float32
    assert np.abs(enc - jenc).max() <= 1e-5 * np.abs(jenc).max()
    assert got.shape == want.shape == (BATCH, CLASSES)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-8, np.abs(got - want).max()
    assert np.abs(whole - want).max() <= 1e-5, np.abs(whole - want).max()


def test_dryrun_multichip_on_two_cpu_ranks(capfd):
    ranks = dryrun_multichip(2, device="cpu")
    out = capfd.readouterr()
    text = out.out + out.err
    assert "exploding gradient" not in text
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert f"dryrun rank {r['rank']} of 2: gloo on cpu" in text
        assert r["eval_routes"] == ["edge_sharded"] * 2
        assert r["solves_max_abs_diff"] <= 1e-4
        # FGSM moved the images by eps
        assert abs(r["attack_max_step"] - 0.05) <= 1e-6
        # the ranks hold one replicated run
        assert r["loss"] == ranks[0]["loss"]
        assert r["loss_device_data"] == ranks[0]["loss_device_data"]
    # the kernels' plain versions ran on the CPU: no launch counted
    assert all(v == 0 for r in ranks for key in ("k1_launches",
                                                 "k2_launches")
               for v in r[key].values())
