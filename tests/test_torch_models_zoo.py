"""The port's encoder zoo (``models/``) against the JAX package's, in float64.

Weights go from each flax model to its twin through
``utils.params_from_jax``; inputs are the same numpy batch, NHWC for JAX
and NCHW for the port.  Every model with BatchNorm is compared in eval mode
(running statistics) and in train mode (batch statistics), and the running
statistics that train mode updates are compared too; dropout is set to 0
in train mode where the class takes a rate.  The bar is 1e-9 of each
output's largest entry.

The flax models cast their features to float32 at the feature boundary
(``astype(jnp.float32)``).  To hold the port to float64, the JAX model
modules see a ``jnp`` whose ``float32`` is float64 while they are traced
here (``_f64_jax_models``); nothing in the JAX package changes.

PreAct nets run at one block a stage and WRN at depth 10, the smallest each
class allows; ``wrn_28_*`` and ``preact_resnet50`` and deeper are checked
for output shape and for every flax leaf finding its place.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearninglayer_tpu.models as jm
from graphlearninglayer_tpu.models import buildnet as jbuildnet
from graphlearninglayer_tpu.models import cnn as jcnn
from graphlearninglayer_tpu.models import preact_resnet as jpreact
from graphlearninglayer_tpu.models import resnet as jresnet
from graphlearninglayer_tpu.models import resnet_mnist as jresnet_mnist
from graphlearninglayer_tpu.models import wrn as jwrn
import graphlearninglayer_tpu_torch.models as tm
from graphlearninglayer_tpu_torch.utils import params_from_jax

F64 = jnp.float64


class _F64Numpy:
    """jax.numpy with ``float32`` read as float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(autouse=True, scope="module")
def _f64_jax_models():
    mods = (jcnn, jpreact, jwrn, jresnet, jresnet_mnist, jbuildnet)
    saved = [m.jnp for m in mods]
    for m in mods:
        m.jnp = _F64Numpy()
    # the wrappers' ResNets take the default (float32) compute dtype
    # and, for the wrappers' tests, a one-block-a-stage ResNet on both sides
    saved_dict = dict(jresnet_mnist.mnist_model_dict)
    jresnet_mnist.mnist_model_dict["resnet10"] = (
        lambda: jresnet.ResNet(jresnet.BasicBlock, (1, 1, 1, 1), dtype=F64),
        512)
    tm.mnist_model_dict["resnet10"] = (
        lambda in_channel=1: tm.ResNet(tm.BasicBlock, (1, 1, 1, 1),
                                       in_channel=in_channel), 512)
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny ops; the suite's workers share cores
    yield
    jresnet_mnist.mnist_model_dict.clear()
    jresnet_mnist.mnist_model_dict.update(saved_dict)
    del tm.mnist_model_dict["resnet10"]
    torch.set_num_threads(n)
    for m, s in zip(mods, saved):
        m.jnp = s


def _init(jmodel, shape, rng, *args):
    """float64 flax variables drawn from ``rng`` on the shapes of
    ``jmodel.init`` (traced abstractly, so no flax init runs): kernels
    normal with variance 1 / fan-in, biases 0.1 N(0, 1), and BN (and
    weight-norm) scales, biases and running statistics randomized, so
    every leaf is exercised."""
    shapes = jax.eval_shape(
        lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(1)}, x, *args),
        jax.ShapeDtypeStruct(shape, F64))

    def leaf(path, a):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if "BatchNorm" in name or "scale" in name:
            if name.endswith(("scale", "var")):
                return rng.uniform(0.5, 1.5, a.shape)
            return 0.2 * rng.normal(size=a.shape)
        if name.endswith("kernel"):
            return rng.normal(size=a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        return 0.1 * rng.normal(size=a.shape)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    return v["params"], v.get("batch_stats", {})


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= 1e-9, f"{what}: {err} of the largest entry"


def _bn_sizes(tmodel):
    """{BatchNorm2d prefix: N = B*H*W of its input}, filled by a forward."""
    sizes, hooks = {}, []
    for name, m in tmodel.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(functools.partial(
                lambda nm, mod, inp, out: sizes.__setitem__(
                    nm, inp[0].shape[0] * inp[0].shape[2] * inp[0].shape[3]),
                name)))
    return sizes, hooks


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _check(jmodel, tmodel, shape, rng, train=True):
    """``tmodel`` with ``jmodel``'s weights agrees with it on one batch in
    eval mode and, with ``train``, in train mode and in the running
    statistics that train mode leaves."""
    params, stats = _init(jmodel, shape, rng, False)
    tmodel = tmodel.double()
    tmodel.load_state_dict(params_from_jax(params, stats, tmodel),
                           strict=True)
    x = rng.normal(size=shape)
    xt = torch.tensor(x.transpose(0, 3, 1, 2))
    variables = {"params": params, "batch_stats": stats} if stats else \
        {"params": params}

    @jax.jit
    def both(variables, x):
        ev = jmodel.apply(variables, x, train=False)
        if not train:
            return ev, None
        if stats:
            return ev, jmodel.apply(variables, x, train=True,
                                    mutable=["batch_stats"])
        return ev, (jmodel.apply(variables, x, train=True), {})

    ev, tr = both(variables, jnp.asarray(x))
    tmodel.eval()
    with torch.no_grad():
        got = _outputs(tmodel(xt))
    for i, (g, w) in enumerate(zip(got, _outputs(ev))):
        _close(g, w, f"eval output {i}")
    if not train:
        return
    (jout, upd) = tr
    sizes, hooks = _bn_sizes(tmodel)
    tmodel.train()
    with torch.no_grad():
        got = _outputs(tmodel(xt))
    for h in hooks:
        h.remove()
    for i, (g, w) in enumerate(zip(got, _outputs(jout))):
        _close(g, w, f"train output {i}")
    if not stats:
        return
    before = params_from_jax(params, stats, tmodel)
    after = params_from_jax(params, upd["batch_stats"], tmodel)
    tsd = tmodel.state_dict()
    assert sizes
    for prefix, n in sizes.items():
        _close(tsd[prefix + ".running_mean"], after[prefix + ".running_mean"],
               prefix + " running_mean")
        # PyTorch updates running_var with the UNBIASED batch variance,
        # flax with the biased one: new = 0.9 old + 0.1 var.  Scale flax's
        # batch variance by N / (N - 1), N = B*H*W at this layer.
        old = before[prefix + ".running_var"].numpy()
        batch_var = after[prefix + ".running_var"].numpy() - 0.9 * old
        _close(tsd[prefix + ".running_var"],
               0.9 * old + batch_var * n / (n - 1), prefix + " running_var")


def test_custom_cnn_and_small_net(rng):
    _check(jm.CustomCNN(dtype=F64), tm.CustomCNN(), (2, 28, 28, 1), rng,
           train=False)
    # SmallNet's dropout rates are fixed, and it has no BatchNorm
    _check(jm.SmallNet(), tm.SmallNet(), (2, 28, 28, 1), rng, train=False)


def test_cifar_cnn(rng):
    """The weight-normed convs, and the pool window clamped to 5 at 28x28
    (at 32x32 it is the reference's 6)."""
    _check(jm.CifarCNN(dtype=F64, dropout_rate=0.0),
           tm.CifarCNN(dropout_rate=0.0), (2, 28, 28, 3), rng)


def test_small_cnn_pair(rng):
    _check(jm.SmallCNN(dropout_rate=0.0), tm.SmallCNN(dropout_rate=0.0),
           (3, 28, 28, 1), rng)
    _check(jm.SmallCNNGL(dropout_rate=0.0), tm.SmallCNNGL(dropout_rate=0.0),
           (3, 28, 28, 1), rng)


@pytest.mark.parametrize("block", ["PreActBlock", "PreActBottleneck"])
def test_preact_resnet_feat(rng, block):
    jblock, tblock = getattr(jpreact, block), getattr(tm, block)
    _check(jm.PreActResNetFeat(jblock, (1, 1, 1, 1), feat_dim=16,
                               dtype=F64),
           tm.PreActResNetFeat(tblock, (1, 1, 1, 1), feat_dim=16),
           (2, 32, 32, 3), rng)


def test_preact_resnet_plain(rng):
    _check(jm.PreActResNetPlain(jpreact.PreActBlock, (1, 1, 1, 1),
                                dtype=F64),
           tm.PreActResNetPlain(tm.PreActBlock, (1, 1, 1, 1)),
           (2, 32, 32, 3), rng)


@pytest.mark.parametrize("size", [28, 32])
def test_wide_resnet(rng, size):
    """Depth 10 (one block a stage), width 1; the pool window clamped to
    7 at 28x28."""
    _check(jwrn.WideResNet(10, 1, 0.0, dtype=F64), tm.WideResNet(10, 1, 0.0),
           (2, size, size, 3), rng)


def test_resnet_mnist_wrappers(rng):
    """On a one-block-a-stage ResNet (``resnet10``, patched into both
    registries above); ``mnist_resnet*`` are the ResNet twins already held
    against JAX in test_torch_models.py."""
    _check(jm.SupConResNet(name="resnet10", head="mlp", feat_dim=16),
           tm.SupConResNet("resnet10", "mlp", feat_dim=16), (2, 28, 28, 1),
           rng)
    _check(jm.SupConResNet(name="resnet10", head="linear", feat_dim=16),
           tm.SupConResNet("resnet10", "linear", feat_dim=16),
           (2, 28, 28, 1), rng, train=False)
    _check(jm.SupCEResNet(name="resnet10", num_classes=5),
           tm.SupCEResNet("resnet10", num_classes=5), (2, 28, 28, 1), rng,
           train=False)
    jprobe = jm.LinearClassifier(name="resnet18")
    feats = rng.normal(size=(3, 512))
    params, _ = _init(jprobe, (3, 512), rng)
    probe = tm.LinearClassifier("resnet18").double()
    probe.load_state_dict(params_from_jax(params, {}, probe), strict=True)
    _close(probe(torch.tensor(feats)).detach(),
           jprobe.apply({"params": params}, jnp.asarray(feats)), "probe")
    assert {k: d for k, (_, d) in tm.mnist_model_dict.items()
            if k != "resnet10"} == {"resnet18": 512, "resnet34": 512,
                                    "resnet50": 2048, "resnet101": 2048}


def test_buildnet_space_to_depth_stem(rng):
    """``resnet18_s2d`` through BuildNet (the patch fold's channel order,
    the widened stem, the strides), its twin configured from the flax
    trees alone (``params_from_jax(..., model=None)``).  The other new
    entries' BuildNet trees load by test_buildnet_every_encoder_every_
    input_size; their encoders are held against JAX above."""
    jmodel = jm.BuildNet(name="resnet18_s2d", head="mlp", feat_dim=16,
                         num_classes=4, dtype=F64)
    params, stats = _init(jmodel, (2, 32, 32, 3), rng, False)
    tmodel = tm.BuildNet("resnet18_s2d", head="mlp", feat_dim=16,
                         num_classes=4)
    tmodel.double().load_state_dict(params_from_jax(params, stats),
                                    strict=True)
    _check(jmodel, tmodel, (2, 32, 32, 3), rng)


def _zeros_variables(jmodel, shape):
    shapes = jax.eval_shape(
        lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(0)}, x,
                              train=False), jnp.zeros(shape))
    v = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               shapes)
    return v["params"], v.get("batch_stats", {})


@pytest.mark.parametrize("make", [
    lambda: (jm.preact_resnet34(), tm.preact_resnet34()),
    lambda: (jm.preact_resnet50(), tm.preact_resnet50()),
    lambda: (jm.wrn_28_2(), tm.wrn_28_2()),
    lambda: (jm.wrn_28_8(), tm.wrn_28_8()),
    lambda: (None, tm.preact_resnet101()),
    lambda: (None, tm.preact_resnet152()),
])
def test_deep_models_shapes_and_every_leaf_placed(make):
    """Every flax leaf of the deep nets finds its place (a strict load), and
    the port's output has the JAX output's shape.  Shapes only, on both
    sides: ``jax.eval_shape`` and PyTorch's meta device.  For
    ``preact_resnet101`` and ``152`` (the blocks of ``preact_resnet50``,
    more of them) the port's shapes alone."""
    with torch.device("meta"):
        jmodel, tmodel = make()
    got = _outputs(tmodel.eval()(torch.zeros(1, 3, 32, 32, device="meta")))
    got = [tuple(g.shape) for g in got]
    if jmodel is None:
        assert got == [(1, 10), (1, 128)]
        return
    params, stats = _zeros_variables(jmodel, (1, 32, 32, 3))
    tmodel.load_state_dict(params_from_jax(params, stats, tmodel),
                           strict=True, assign=True)
    want = jax.eval_shape(
        functools.partial(jmodel.apply, train=False),
        {"params": params, "batch_stats": stats}, jnp.zeros((1, 32, 32, 3)))
    assert got == [w.shape for w in jax.tree_util.tree_leaves(want)]


@pytest.mark.parametrize("name", sorted(tm.model_dict))
def test_buildnet_every_encoder_every_input_size(name):
    """Every registered encoder composes with BuildNet at the MNIST-family
    (28x28) and CIFAR-family (32x32) geometries (shapes, on the meta
    device), and its flax BuildNet's trees load into it (strict)."""
    with torch.device("meta"):
        model = tm.BuildNet(name, head="mlp", feat_dim=16, num_classes=4)
    for size in (28, 32):
        pred, feat = model(torch.zeros(2, 3, size, size, device="meta"))
        assert pred.shape == (2, 4) and feat.shape == (2, 16)
    params, stats = _zeros_variables(
        jm.BuildNet(name=name, head="mlp", feat_dim=16, num_classes=4),
        (1, 32, 32, 3))
    model.load_state_dict(params_from_jax(params, stats), strict=True,
                          assign=True)


def test_small_cnn_zero_init_and_seeded_init():
    """The final linear starts at zero (the uniform distribution), whatever
    generator draws the rest; a seeded generator repeats the draw, and a
    weight-normed conv starts with w = v."""
    x = torch.randn(4, 1, 28, 28)
    a = tm.SmallCNN(generator=torch.Generator().manual_seed(3)).eval()
    b = tm.SmallCNN(generator=torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        out = a(x)
    torch.testing.assert_close(out, torch.full_like(out, np.log(0.1)))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    c = tm.CifarCNN()
    tm.init_weights(c, torch.Generator().manual_seed(0))
    wn = c.conv1a.parametrizations.weight
    torch.testing.assert_close(c.conv1a.weight, wn.original1)


def test_dropout_draws_from_its_generator():
    """flax semantics (keep 1 - p, scale the kept by 1 / (1 - p)); the same
    generator state gives the same mask, and each call a fresh one."""
    drop = tm.Dropout(0.5).train()
    x = torch.ones(4000)
    drop.generator = torch.Generator().manual_seed(0)
    first, second = drop(x), drop(x)
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), first)
    assert not torch.equal(first, second)
    assert set(first.unique().tolist()) == {0.0, 2.0}
    assert abs(first.mean().item() - 1.0) < 0.1
    assert torch.equal(drop.eval()(x), x)
