"""The port's standalone visualization CLI (``evalx/visualize.py::main``)
on the CPU: it restores a checkpoint of the port, encodes train and test
images, writes the embedding PNG pair per split and prints the probe
accuracy, as tests/test_visualize.py holds the JAX CLI to; where the
plotting or probe packages are missing it says "skipped"."""
import importlib
import os

import numpy as np
import pytest
import torch

import graphlearninglayer_tpu_torch.data as data_pkg
from graphlearninglayer_tpu_torch.data import Transform, load_dataset
from graphlearninglayer_tpu_torch.evalx import encode_dataset
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                make_encode_step,
                                                make_lr_schedule)
from graphlearninglayer_tpu_torch.utils.checkpoint import save_checkpoint
from tests import torch_tiny

# the module (the package's name 'visualize' is its function)
viz = importlib.import_module("graphlearninglayer_tpu_torch.evalx.visualize")

ARGS = ["--dataset", "synthetic", "--model", "tinycnn", "--embedding_dim",
        "16", "--max_points", "40", "--dev", "cpu"]


def _small_dataset(name, allow_synthetic_fallback=False, **kw):
    """The CLI's loader cut to 96 train and 48 test images."""
    return load_dataset(name, allow_synthetic_fallback, n_train=96,
                        n_test=48, **kw)


@pytest.fixture()
def ckpt(tmp_path, monkeypatch):
    torch_tiny.register(monkeypatch)
    # main imports the loader from the data package when it runs
    monkeypatch.setattr(data_pkg, "load_dataset", _small_dataset)
    # PCA for the 2-D embedding: t-SNE, the fallback when umap is absent,
    # takes seconds on the CPU; the plots and the probe are the point
    embed = viz.embed_2d
    monkeypatch.setattr(viz, "embed_2d",
                        lambda f, method="auto", seed=0: embed(f, "pca", seed))
    model = BuildNet("tinycnn", head="mlp", feat_dim=16, num_classes=10,
                     in_channel=1, generator=torch.Generator().manual_seed(3))
    state = create_train_state(model, make_lr_schedule(0.1, 1, 1),
                               device="cpu")
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state, 3)
    return path, state


def test_cli_restores_encodes_plots_and_probes(ckpt, capsys):
    path, state = ckpt
    feats = viz.main([path, "--probe"] + ARGS)
    out = capsys.readouterr().out
    assert "restored checkpoint epoch 3" in out
    assert "Linear Classifier Accuracy is" in out
    spec = load_dataset("synthetic", n_train=96, n_test=48)
    tf = Transform("synthetic", "eval")
    step = make_encode_step(norm=(tf.mean, tf.std), device="cpu")
    rng = np.random.default_rng(0)
    for split, n_all in (("train", 96), ("test", 48)):
        assert os.path.exists(os.path.join(path,
                                           f"synthetic_{split}_umap.png"))
        f, labels = feats[split]
        assert f.shape == (40, 16) and np.isfinite(f).all()
        # the checkpoint's weights encode the sampled rows
        sel = rng.permutation(n_all)[:40]
        images = getattr(spec, f"{split}_images")[sel]
        np.testing.assert_array_equal(
            labels, getattr(spec, f"{split}_labels")[sel])
        want = encode_dataset(step, state, images).numpy()
        np.testing.assert_allclose(f, want, atol=1e-6)


def test_cli_says_skipped_without_plot_and_probe_packages(ckpt, capsys,
                                                          monkeypatch,
                                                          tmp_path):
    def missing(*a, **kw):
        raise ImportError("No module named 'sklearn'")

    monkeypatch.setattr(viz, "embed_2d", missing)
    monkeypatch.setattr(viz, "linear_probe_accuracy", missing)
    feats = viz.main([ckpt[0], "--probe", "--save_dir",
                      str(tmp_path / "out")] + ARGS)
    out = capsys.readouterr().out
    assert out.count("plots skipped") == 2 and "probe skipped" in out
    assert {k: v[0].shape for k, v in feats.items()} == {
        "train": (40, 16), "test": (40, 16)}


def test_cli_raises_without_cuda_unless_dev_cpu(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--dev cpu"):
        viz.main([ckpt[0]] + ARGS[:-2])
