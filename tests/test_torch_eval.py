"""The whole slice: the port's transductive eval (``evalx/harness.py::
test_gl_transductive``) on the CPU with a ResNet-18 ``BuildNet`` over
8 base + 16 train + 8 test random 32x32x3 images, 4 classes.

The features it solves on must equal ``encode_dataset``'s, and its scores
and accuracy must equal those of the JAX package's ``transductive_laplace``
on the same features, scores within 1e-6.  The model runs in float64: a
freshly initialised encoder maps these images to features within d2 ~ 0.003
of each other, where float32 distances lose three digits and each framework's
float32 scores are ~1e-4 from float64.  The encoders themselves are held
against JAX in ``test_torch_models.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.ops import transductive_laplace as jtransductive
from graphlearninglayer_tpu_torch.data import CHANNEL_STATS
from graphlearninglayer_tpu_torch.evalx import harness
from graphlearninglayer_tpu_torch.evalx import \
    test_gl_transductive as gl_transductive
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.ops import EvalGraphCache
from graphlearninglayer_tpu_torch.parallel import make_mesh
from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                make_encode_step,
                                                make_lr_schedule)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU ops are tiny: one thread runs them faster, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NUM_CLASSES, NORM, BATCH = 4, CHANNEL_STATS["cifar10"], 16


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (32, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, NUM_CLASSES, 32)
    model = BuildNet("resnet18", head="mlp", feat_dim=128,
                     num_classes=NUM_CLASSES,
                     generator=torch.Generator().manual_seed(0))
    state = create_train_state(model.double(), make_lr_schedule(0.01, 1, 1),
                               device="cpu")
    parts = {"base": (images[:8], labels[:8]),
             "train": (images[8:24], labels[8:24]),
             "test": (images[24:], labels[24:])}
    return state, parts


def _run(setup, monkeypatch, **kw):
    state, parts = setup
    seen = {}
    solve = harness.transductive_laplace
    def capture(x, y, **k):
        seen.update(x=x, y=y, **k)
        seen["out"] = solve(x, y, **k)
        return seen["out"]

    monkeypatch.setattr(harness, "transductive_laplace", capture)
    stats = {}
    acc = gl_transductive(state, *parts["base"], *parts["test"], None,
                          NUM_CLASSES, train_images=parts["train"][0],
                          norm=NORM, batch_size=BATCH, device="cpu",
                          stats=stats, **kw)
    return acc, seen, stats


def test_gl_transductive_matches_jax_solve(setup, monkeypatch, capsys):
    state, parts = setup
    cache = EvalGraphCache()
    acc, seen, stats = _run(setup, monkeypatch, knn_num=10, cache=cache)
    assert "Test set: Accuracy for GL predictor" in capsys.readouterr().out
    assert stats["n_nodes"] == 32 and stats["cg_err"] <= 1e-10
    assert seen["knn_num"] == 10 and seen["tau"] == 1e-8

    # the features are encode_dataset's: base first, test last
    x = seen["x"]
    assert x.shape == (32, 128) and x.dtype == torch.float64
    step = make_encode_step(norm=NORM, device="cpu")
    for part, rows in (("base", x[:8]), ("test", x[-8:])):
        want = harness.encode_dataset(step, state, parts[part][0],
                                      batch_size=BATCH)
        np.testing.assert_array_equal(rows.numpy(), want.numpy())
    np.testing.assert_array_equal(seen["y"].numpy(),
                                  np.eye(NUM_CLASSES)[parts["base"][1]])

    pred_j, _, _ = jtransductive(jnp.asarray(x.numpy()),
                                 jnp.asarray(seen["y"].numpy()), knn_num=10,
                                 return_info=True)
    pred_j = np.asarray(pred_j)
    np.testing.assert_allclose(seen["out"][0].numpy(), pred_j, atol=1e-6,
                               rtol=0)
    acc_j = 100.0 * np.mean(pred_j.argmax(1)[-8:] == parts["test"][1])
    assert acc == pytest.approx(acc_j)


def test_gl_transductive_caps_k_and_guards(setup, monkeypatch):
    # a stand-in encoder (the first 128 bytes of each image) keeps this
    # test off the ResNet: the cap needs only the node count
    monkeypatch.setattr(
        harness, "make_encode_step",
        lambda norm, device: lambda state, x: torch.nn.functional.normalize(
            torch.as_tensor(x).reshape(len(x), -1)[:, :128].double(),
            dim=1))
    _, seen, _ = _run(setup, monkeypatch)          # knn_num=50 > 32 nodes
    assert seen["knn_num"] == 32
    # the resident eval (ported): the same stand-in over the splits on the
    # device, base rows gathered from the train features
    monkeypatch.setattr(
        harness, "make_encode_step_from_data",
        lambda image_shape, batch, norm, device: lambda state, data, start:
        harness.make_encode_step(norm, device)(
            state, data[start:start + batch]))
    state, parts = setup
    flat = lambda a: torch.from_numpy(a.reshape(len(a), -1))
    first = seen["x"]
    _, seen, _ = _run(setup, monkeypatch, resident=(
        flat(np.concatenate([parts["base"][0], parts["train"][0]])),
        flat(parts["test"][0]), np.arange(8), (32, 32, 3)))
    assert seen["knn_num"] == 32 + 8   # the base rows are train rows here
    np.testing.assert_array_equal(seen["x"][:8].numpy(),
                                  first[:8].numpy())
    np.testing.assert_array_equal(seen["x"][-8:].numpy(),
                                  first[-8:].numpy())
    # a mesh of one rank keeps the single-device solve and its result
    args = (state, *parts["base"], *parts["test"], None, NUM_CLASSES)
    stats = {}
    acc = gl_transductive(*args, mesh=make_mesh(1, axes=("graph",),
                                                device="cpu"),
                          shard_min_n=1, stats=stats)
    assert stats["route"] == "single"
    assert acc == gl_transductive(*args, device="cpu")


def test_encode_dataset_pads_and_trims_the_tail(setup):
    state, parts = setup
    images = parts["train"][0][:5]
    calls = []
    step = make_encode_step(norm=NORM, device="cpu")
    feats = harness.encode_dataset(
        lambda s, x: calls.append(len(x)) or step(s, x), state, images,
        batch_size=4)
    assert calls == [4, 4] and feats.shape == (5, 128)
    whole = harness.encode_dataset(step, state, images, batch_size=5)
    np.testing.assert_allclose(feats.numpy(), whole.numpy(), atol=1e-12)
