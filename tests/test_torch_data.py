"""The port's data modules (``data/datasets.py``, ``augment.py``,
``native.py``, ``pipeline.py``) against the JAX package's.

Every comparison is exact: the same files, seeds and arguments must give
byte-identical uint8 images, labels, index streams and base picks.  The
loaders read the checked-in miniature fixtures (tests/fixtures) and small
files this test writes in the real formats (gzipped IDX, CIFAR pickles, the
mini-ImageNet npz cache).
"""
import gzip
import os
import pickle
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from graphlearninglayer_tpu import data as jdata
from graphlearninglayer_tpu.data import native as jnative
from graphlearninglayer_tpu.data import pipeline as jpipe
from graphlearninglayer_tpu_torch import data as tdata
from graphlearninglayer_tpu_torch.data import native as tnative
from graphlearninglayer_tpu_torch.data import pipeline as tpipe


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU ops are tiny: one thread runs them faster, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _same_spec(a, b):
    assert (a.name, a.num_classes) == (b.name, b.num_classes)
    for key in ("train_images", "train_labels", "test_images",
                "test_labels"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("root,name", [
    ("data", "mnist"), ("data", "fashion_mnist"), ("data", "cifar10"),
    ("data", "cifar100"), ("data", "miniimagenet"),
    ("data_folder", "miniimagenet")])
def test_loaders_match_jax_on_fixtures(monkeypatch, tmp_path, root, name):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GLL_DATA_DIR", os.path.join(FIXTURES, root))
    _same_spec(tdata.load_dataset(name), jdata.load_dataset(name))


def _write_idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def test_loaders_match_jax_on_written_files(monkeypatch, tmp_path):
    rng = np.random.default_rng(0)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GLL_DATA_DIR", str(tmp_path))
    os.makedirs(tmp_path / "mnist" / "raw")
    for split, n in (("train", 20), ("t10k", 10)):
        _write_idx(tmp_path / "mnist" / "raw" / f"{split}-images-idx3-ubyte.gz",
                   rng.integers(0, 256, (n, 28, 28)))
        _write_idx(tmp_path / "mnist" / "raw" / f"{split}-labels-idx1-ubyte.gz",
                   rng.integers(0, 10, n))
    os.makedirs(tmp_path / "cifar-100-python")
    for split, n in (("train", 12), ("test", 6)):
        with open(tmp_path / "cifar-100-python" / split, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"fine_labels": list(rng.integers(0, 100, n))}, f)
    np.savez(tmp_path / "miniimagenet.npz",
             train_images=rng.integers(0, 256, (8, 84, 84, 3), dtype=np.uint8),
             train_labels=rng.integers(0, 100, 8),
             test_images=rng.integers(0, 256, (4, 84, 84, 3), dtype=np.uint8),
             test_labels=rng.integers(0, 100, 4))
    for name in ("mnist", "cifar100", "miniimagenet"):
        _same_spec(tdata.load_dataset(name), jdata.load_dataset(name))
    # no files: an error, or the synthetic stand-in at the dataset geometry
    with pytest.raises(FileNotFoundError):
        tdata.load_dataset("cifar10")
    kw = dict(n_train=16, n_test=8, class_sep=1.5, label_noise=0.2)
    _same_spec(tdata.load_dataset("cifar10", True, **kw),
               jdata.load_dataset("cifar10", True, **kw))
    assert set(tdata.DATASETS) == set(jdata.datasets.DATASETS)


def test_synth_option_parsing_matches_jax():
    from graphlearninglayer_tpu.data.datasets import (
        parse_synth_overrides, synth_kwargs_from_opt)

    opt = SimpleNamespace(synth_n_train=64, synth_n_test=16, synth_sep=2.0,
                          synth_modes=2, synth_noise=0.3,
                          synth_label_noise=0.1)
    assert tdata.synth_kwargs_from_opt(opt) == synth_kwargs_from_opt(opt)
    toks = ["synth_sep=1.5", "n_train=40", "seed=3", "latent_dim=8"]
    assert tdata.parse_synth_overrides(toks) == parse_synth_overrides(toks)
    with pytest.raises(ValueError, match="unknown synthetic override"):
        tdata.parse_synth_overrides(["bogus=1"])


@pytest.mark.parametrize("dataset,mode", [("cifar10", "strong"),
                                          ("cifar10", "weak"),
                                          ("synthetic", "strong")])
def test_pil_transform_matches_jax(dataset, mode):
    shape = (32, 32, 3) if dataset == "cifar10" else (28, 28, 1)
    imgs = np.random.default_rng(1).integers(0, 256, (12,) + shape,
                                             dtype=np.uint8)
    tt, jt = tdata.Transform(dataset, mode), jdata.Transform(dataset, mode)
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(tt(img, np.random.default_rng(i)),
                                      jt(img, np.random.default_rng(i)))
    batch = imgs.astype(np.uint8)
    np.testing.assert_array_equal(tt.normalize(batch), jt.normalize(batch))


def test_float_helpers_match_jax():
    from graphlearninglayer_tpu.data import augment as jaug
    from graphlearninglayer_tpu_torch.data import augment as taug

    img = np.random.default_rng(2).normal(size=(16, 16, 3)).astype(
        np.float32)
    eig = ([0.2, 0.1, 0.05], np.eye(3))
    np.testing.assert_array_equal(
        taug.Lighting(0.1, *eig)(img, np.random.default_rng(3)),
        jaug.Lighting(0.1, *eig)(img, np.random.default_rng(3)))
    np.testing.assert_array_equal(
        taug.cutout_default(img, 6, np.random.default_rng(4)),
        jaug.cutout_default(img, 6, np.random.default_rng(4)))


def test_native_library_matches_jax_library():
    assert tnative.native_available() and jnative.native_available()
    rng = np.random.default_rng(5)
    batch = rng.integers(0, 256, (24, 32, 32, 3), dtype=np.uint8)
    seeds = rng.integers(0, 2 ** 63, 24, dtype=np.uint64)
    kw = dict(rand_n=2, rotation=0, flip=True, pad=4, pad_reflect=True)
    got = tnative.augment_batch_native(batch, seeds, **kw)
    np.testing.assert_array_equal(got,
                                  jnative.augment_batch_native(batch, seeds,
                                                               **kw))
    assert not np.array_equal(got, batch)
    stats = tdata.CHANNEL_STATS["cifar10"]
    np.testing.assert_array_equal(
        tnative.normalize_batch_native(got, *stats),
        jnative.normalize_batch_native(got, *stats))
    for op in ("equalize", "shear_x", "solarize"):
        np.testing.assert_array_equal(
            tnative.apply_op_native(batch[0], op, 0.2, True),
            jnative.apply_op_native(batch[0], op, 0.2, True))


@pytest.mark.parametrize("backend", ["native", "pil"])
def test_batch_loader_streams_match_jax(backend):
    """Epoch order, augmented uint8 batches, labels and the base-batch
    stream of the port's BatchLoader equal the JAX package's (prefetching,
    two epochs, base batches drawn between them)."""
    spec = jdata.synthetic_dataset(10, (32, 32, 3), n_train=40, n_test=8)
    base_x, base_y = spec.train_images[:10], spec.train_labels[:10]

    def run(mod):
        loader = mod.BatchLoader(
            spec.train_images, spec.train_labels, 16,
            mod.Transform("cifar10", "strong"), seed=7, workers=2,
            backend=backend, emit="uint8")
        out = []
        for _ in range(2):
            out += [(np.asarray(i), np.asarray(x), np.asarray(y))
                    for i, x, y in loader]
            out += [(None, np.asarray(x), np.asarray(y))
                    for x, y in loader.base_batches(base_x, base_y)]
        return out

    got, want = run(tdata), run(jdata)
    assert len(got) == len(want) == 8
    for (gi, gx, gy), (wi, wx, wy) in zip(got, want):
        if wi is not None:
            np.testing.assert_array_equal(gi, wi)
        assert gx.dtype == np.uint8
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_batch_loader_to_device_and_two_crop():
    spec = jdata.synthetic_dataset(10, (16, 16, 3), n_train=32, n_test=8)
    tf = tdata.Transform("cifar10", "weak")
    loader = tdata.BatchLoader(spec.train_images, spec.train_labels, 16, tf,
                               seed=1, workers=0, emit="uint8",
                               to_device="cpu")
    idx, x, y = next(iter(loader))
    assert isinstance(x, torch.Tensor) and x.dtype == torch.uint8
    assert isinstance(y, torch.Tensor) and tuple(x.shape) == (16, 16, 16, 3)
    with pytest.raises(ValueError, match="unknown emit"):
        tdata.BatchLoader(spec.train_images, spec.train_labels, 16, tf,
                          emit="float16")
    args = (spec.train_images, spec.train_labels, 8, tf)
    got = [v for _, v, _ in tpipe.TwoCropBatchLoader(*args, seed=3,
                                                     workers=0)]
    want = [v for _, v, _ in jpipe.TwoCropBatchLoader(*args[:3],
                                                      jdata.Transform(
                                                          "cifar10", "weak"),
                                                      seed=3, workers=0)]
    assert got[0].shape == (8, 2, 16, 16, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["random", "score"])
def test_base_selection_matches_jax(mode):
    rng = np.random.default_rng(8)
    labels = rng.integers(0, 5, 200)
    scores = rng.random(200).astype(np.float32)
    got = tdata.select_base_indices(labels, 25, 5, mode, scores,
                                    np.random.default_rng(9))
    want = jdata.select_base_indices(labels, 25, 5, mode, scores,
                                     np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)
    spec = jdata.synthetic_dataset(5, (8, 8, 1), n_train=60, n_test=5)
    tds, jds = tdata.ScoredDataset(spec), jdata.ScoredDataset(spec)
    for ds in (tds, jds):
        ds.update_scores(np.arange(30), scores[:30])
    for a, b in zip(tds.select_base(10, mode, np.random.default_rng(1),
                                    return_indices=True),
                    jds.select_base(10, mode, np.random.default_rng(1),
                                    return_indices=True)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdata.downsample_by_stride(spec.train_images,
                                               spec.train_labels, 3),
                    jdata.downsample_by_stride(spec.train_images,
                                               spec.train_labels, 3)):
        np.testing.assert_array_equal(a, b)


def test_data_package_imports_and_augments_without_pil():
    """The machine with the card has no PIL: the data package imports
    without it and the loader takes the native backend."""
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from graphlearninglayer_tpu_torch import data\n"
        "imgs = np.zeros((8, 16, 16, 3), np.uint8)\n"
        "ld = data.BatchLoader(imgs, np.zeros(8, int), 4,\n"
        "                      data.Transform('cifar10', 'strong'), workers=0,\n"
        "                      emit='uint8')\n"
        "assert ld.backend == 'native', ld.backend\n"
        "assert next(iter(ld))[1].shape == (4, 16, 16, 3)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
