"""The port's FullySup driver (``train/fullysup.py``) on the CPU.

The scenarios of tests/test_fullysup_driver.py that do not use
``--device_data`` (tests/test_torch_device_data.py has those), run on the
port with a tiny encoder patched into the
port's ``model_dict`` (synthetic 28x28x1 data, 96 train / 32 test images,
batch 32, 10 base images, k=6).  The JAX driver is not run here: the
initial base pick is held against the JAX package's
``ScoredDataset.select_base`` for the same seed.
"""
import importlib
import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import graphlearninglayer_tpu_torch.evalx as evalx_mod
from graphlearninglayer_tpu.data import ScoredDataset as JScoredDataset
from graphlearninglayer_tpu.data import load_dataset as jload_dataset
from graphlearninglayer_tpu_torch.config.cli import parse_option
from graphlearninglayer_tpu_torch.models import buildnet as bn
from graphlearninglayer_tpu_torch.models import l2_normalize
from graphlearninglayer_tpu_torch.train import fullysup


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU ops are tiny: one thread runs them faster, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TinyEncoder(nn.Module):
    def __init__(self, in_channel: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_channel, 8, 3, stride=2, padding=1)
        self.dense = nn.Linear(8, 16)

    def forward(self, x):
        x = torch.relu(self.conv(x)).mean(dim=(2, 3))
        return l2_normalize(self.dense(x))


_PLOTS = fullysup._records_and_plots


@pytest.fixture()
def tiny_opt(tmp_path, monkeypatch):
    monkeypatch.setitem(bn.model_dict, "tinycnn",
                        (lambda in_channel=3: TinyEncoder(in_channel), 16))
    # records only: matplotlib's rendering takes ~1 s a call on the CPU;
    # test_per_interval_visualization_dirs runs the real plots
    monkeypatch.setattr(fullysup, "_records_and_plots",
                        lambda folder, records: np.save(
                            os.path.join(folder, "loss_acc_records.npy"),
                            records, allow_pickle=True))
    argv = ["--dev", "cpu", "--sup_train_type", "gl",
            "--dataset", "synthetic", "--model", "tinycnn", "--epochs", "2",
            "--batch_size", "32", "--num_train", "10", "--knn_k", "6",
            "--synth_n_train", "96", "--synth_n_test", "32",
            "--num_workers", "0", "--plot_freq_ss", "100",
            "--epsilon", "auto", "--viz_max_n", "0"]
    monkeypatch.chdir(tmp_path)  # save/ artifacts land in tmp
    return argv


def test_ds_stepsize_strides_only_initial_base_pool(tiny_opt, monkeypatch):
    """--ds_stepsize strides only the pool the initial base sample is drawn
    from: the train loader, test set and score-refresh pool stay full."""
    calls = []
    orig = fullysup.downsample_by_stride

    def recording(images, labels, stride):
        out = orig(images, labels, stride)
        calls.append((len(images), len(out[0]), stride))
        return out

    monkeypatch.setattr(fullysup, "downsample_by_stride", recording)
    records = fullysup.run_training(parse_option(tiny_opt
                                                 + ["--ds_stepsize", "3"]))
    assert calls == [(96, 32, 3)]
    # the train loader ran on the full split: 96 // 32 = 3 steps an epoch
    assert records["steps_per_epoch"] == 3
    assert len(records["loss"]) == 2
    assert all(np.isfinite(v) for v in records["loss"])


def test_base_pick_matches_jax_and_no_downsampling(tiny_opt, monkeypatch):
    """Without --ds_stepsize nothing is strided, and the initial base pick
    equals the JAX package's for the same seed and data."""
    monkeypatch.setattr(fullysup, "downsample_by_stride",
                        lambda *a: pytest.fail("downsampled"))
    picks = []
    orig = fullysup.ScoredDataset.select_base

    def recording(self, *a, **kw):
        out = orig(self, *a, **kw)
        picks.append(out[2])
        return out

    monkeypatch.setattr(fullysup.ScoredDataset, "select_base", recording)
    opt = parse_option(tiny_opt)
    records = fullysup.run_training(opt)
    assert len(records["loss"]) == 2 and len(picks) == 3  # initial + 2
    spec = jload_dataset("synthetic", n_train=96, n_test=32)
    want = JScoredDataset(spec).select_base(
        10, "random", np.random.default_rng(opt.seed),
        return_indices=True)[2]
    np.testing.assert_array_equal(picks[0], want)


def test_per_interval_visualization_dirs(tiny_opt, monkeypatch):
    """Every plot interval, the final one included, gets an embedding dir,
    a checkpoint and the record plots."""
    # the module (the package's name 'visualize' is its function)
    viz = importlib.import_module("graphlearninglayer_tpu_torch.evalx."
                                  "visualize")
    monkeypatch.setattr(fullysup, "_records_and_plots", _PLOTS)
    # PCA for the 2-D embedding: t-SNE, the fallback when umap is absent,
    # takes seconds on the CPU; the plot and its directory are the point
    embed = viz.embed_2d
    monkeypatch.setattr(viz, "embed_2d",
                        lambda f, method="auto", seed=0: embed(f, "pca", seed))
    opt = parse_option(tiny_opt + ["--plot_freq_ss", "1",
                                   "--viz_max_n", "40"])
    fullysup.run_training(opt)
    for epoch in (1, 2):
        assert os.path.exists(os.path.join(
            opt.save_folder, f"ckpt_epoch_{epoch}", "features_umap.png"))
        assert os.path.exists(os.path.join(
            opt.save_folder, "ckpt", f"ckpt_epoch_{epoch}.pth"))
    assert os.path.exists(os.path.join(opt.save_folder, "loss.png"))
    assert os.path.exists(os.path.join(opt.save_folder,
                                       "loss_acc_records.npy"))


def test_visualization_embeds_train_split_with_base_starred(tiny_opt,
                                                            monkeypatch):
    seen = []

    def recording(features, labels, save_dir, base_mask=None, tsne=False,
                  **kw):
        seen.append((len(features), int(base_mask.sum()),
                     base_mask.argmax()))

    monkeypatch.setattr(evalx_mod, "visualize", recording)
    opt = parse_option(tiny_opt + ["--epochs", "1", "--plot_freq_ss", "1",
                                   "--viz_max_n", "40"])
    fullysup.run_training(opt)
    assert seen
    for n_total, n_base, base_start in seen:
        assert n_base == 10            # --num_train base rows, starred
        assert n_total == 40 + 10      # subsampled train split + base
        assert base_start == 40        # base rows appended after the split


def test_pre_pretrain_eval_when_sup_epochs(tiny_opt):
    """With --sup_epochs > 0 the driver also evaluates before the MLP-head
    pretrain (epoch -1)."""
    rec_plain = fullysup.run_training(parse_option(tiny_opt
                                                   + ["--epochs", "1"]))
    rec_pre = fullysup.run_training(parse_option(
        tiny_opt + ["--epochs", "1", "--sup_epochs", "1"]))
    assert len(rec_plain["test_acc"]) == 2
    assert len(rec_pre["test_acc"]) == 3
    assert all(np.isfinite(v) for v in rec_pre["test_acc"])


def test_pretrain_linear_updates_only_the_classifier(tiny_opt):
    from graphlearninglayer_tpu_torch.data import (BatchLoader, Transform,
                                                   load_dataset)
    from graphlearninglayer_tpu_torch.models import BuildNet
    from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                    make_lr_schedule)

    opt = parse_option(tiny_opt + ["--sup_epochs", "1"])
    spec = load_dataset("synthetic", n_train=96, n_test=32)
    tf = Transform("synthetic", "weak")
    loader = BatchLoader(spec.train_images, spec.train_labels, 32, tf,
                         workers=0, emit="uint8", to_device="cpu")
    model = BuildNet("tinycnn", num_classes=10, in_channel=1,
                     generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_lr_schedule(0.01, 1, 3),
                               device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    fullysup.pretrain_linear(state, loader, opt, norm=(tf.mean, tf.std))
    after = model.state_dict()
    for key, old in before.items():
        moved = not torch.equal(after[key], old)
        assert moved == key.startswith("linear."), key
    assert all(p.requires_grad for p in model.parameters())


def test_resume_with_start_epochs(tiny_opt, capsys):
    """--cp_load_path warms the weights; --start_epochs N restarts the epoch
    loop at N+1, so a 1-epoch run resumed for one more epoch runs exactly
    one epoch; --cp_load_path without --start_epochs warns and restarts at
    epoch 1."""
    opt1 = parse_option(tiny_opt)
    opt1.epochs = 1
    fullysup.run_training(opt1)
    ckpt = os.path.join(opt1.save_folder, "last")
    assert os.path.isfile(os.path.join(ckpt, "ckpt_epoch_1.pth"))

    opt2 = parse_option(tiny_opt + ["--cp_load_path", ckpt,
                                    "--start_epochs", "1",
                                    "--epochs", "1"])
    rec2 = fullysup.run_training(opt2)
    assert len(rec2["loss"]) == 1, rec2["loss"]
    assert all(np.isfinite(v) for v in rec2["loss"])
    out = capsys.readouterr().out
    assert "weights are warmed" not in out

    rec3 = fullysup.run_training(parse_option(tiny_opt
                                              + ["--cp_load_path", ckpt]))
    assert len(rec3["loss"]) == 2
    assert "weights are warmed" in capsys.readouterr().out


def test_mlp_branch_and_cg_solver_run(tiny_opt):
    rec = fullysup.run_training(parse_option(
        [a if a != "gl" else "mlp" for a in tiny_opt]))
    assert len(rec["loss"]) == 2 and len(rec["test_acc"]) == 2
    assert all(np.isfinite(v) for v in rec["loss"])
    rec = fullysup.run_training(parse_option(
        tiny_opt + ["--epochs", "1", "--gl_solver", "cg"]))
    assert np.isfinite(rec["loss"][0]) and rec["cg_iters"][0] > 0


def test_main_tees_stdout_and_unported_options_raise(tiny_opt, capsys,
                                                     monkeypatch):
    records = fullysup.main(tiny_opt + ["--epochs", "1"])
    opt = parse_option(tiny_opt)
    logs = [f for f in os.listdir(opt.save_folder)
            if f.startswith("output_record_")]
    assert len(logs) == 1
    with open(os.path.join(opt.save_folder, logs[0])) as f:
        assert "epoch 1, total time" in f.read()
    assert len(records["loss"]) == 1
    # --device_data is ported: it runs, with the augmentation on the device
    records = fullysup.main(tiny_opt + ["--epochs", "1", "--device_data"])
    assert records["loader_backend"] == "device"
    assert len(records["loss"]) == 1 and np.isfinite(records["loss"][0])
    # so is the multi-device path (tests/test_torch_sharded_driver.py);
    # as in JAX, a mesh wider than the visible cards raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 cards"):
        fullysup.run_training(parse_option(
            [a if a != "cpu" else "cuda" for a in tiny_opt] + ["--mesh", "2"]))
