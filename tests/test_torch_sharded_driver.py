"""The port's FullySup driver on CPU ranks (the scenarios of
tests/test_sharded_driver.py): ``--dev cpu --mesh 2`` spawns two gloo
ranks, and two processes started with a launcher's variables
(``WORLD_SIZE=2``, ``RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) form the
same world.  Either reproduces the single-device run where both start
from the same weights: the first step's loss within 1e-5 relative and the
epoch-0 eval's accuracy exactly; with ``--shard_eval_min_n 1`` every
transductive eval takes the edge-sharded route and converges.  The later
steps are only checked finite: this tiny run's GL op is ill-conditioned
(gradient norms near 1e7), and in float32 the ranks' other summation order
moves the next steps' losses by 1e-4 to 2.5e-3 relative, depending even on
the ranks' thread counts (measured), while in float64 the sharded and
unsharded steps agree to 1e-13 (tests/test_torch_sharded_train.py holds one
float64 step to 1e-12).  The tiny encoder comes from tests/torch_ranks.py,
which the ranks import without JAX.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphlearninglayer_tpu_torch.config.cli import parse_option
from graphlearninglayer_tpu_torch.models import buildnet as bn
from graphlearninglayer_tpu_torch.train import fullysup
from tests import torch_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--dev", "cpu", "--sup_train_type", "gl", "--dataset", "synthetic",
        "--model", "tinycnn", "--epochs", "1", "--batch_size", "32",
        "--num_train", "10", "--knn_k", "6", "--synth_n_train", "96",
        "--synth_n_test", "32", "--num_workers", "0", "--plot_freq_ss", "1",
        "--epsilon", "auto", "--viz_max_n", "0", "--shard_eval_min_n", "1",
        # the tiny run explodes at the default rate, and chaos would
        # amplify the ranks' other summation order across epochs (as in
        # the JAX test's --device_data case)
        "--learning_rate", "0.001", "--grad_warn", "0"]
LAUNCH = ("import sys; from tests import torch_ranks as tr; "
          "from graphlearninglayer_tpu_torch.models import buildnet as bn; "
          "bn.model_dict['tinycnn'] = (tr.ttiny, 16); "
          "from graphlearninglayer_tpu_torch.train import fullysup; "
          "fullysup.main(sys.argv[1:])")


@pytest.fixture()
def tiny(tmp_path, monkeypatch):
    monkeypatch.setitem(bn.model_dict, "tinycnn", (torch_ranks.ttiny, 16))
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


def _same_run(got: dict, want: dict):
    np.testing.assert_allclose(got["step_loss"][0], want["step_loss"][0],
                               rtol=1e-5)
    assert len(got["step_loss"]) == len(want["step_loss"]) == 3
    assert np.isfinite(got["step_loss"]).all()
    assert got["test_acc"][0] == want["test_acc"][0]
    assert [e["route"] for e in got["eval"]] == ["edge_sharded"] * 2
    assert [e["route"] for e in want["eval"]] == ["single"] * 2
    assert all(e["cg_err"] <= 1e-10 for e in got["eval"])


def test_fullysup_mesh_matches_single_device_and_shards_the_eval(tiny):
    off = fullysup.run_training(parse_option(ARGV + ["--mesh", "off"]))
    on = fullysup.run_training(parse_option(ARGV + ["--mesh", "2"]))
    assert off["mesh"] is None
    # one host: its ranks on the 'graph' axis, as the JAX global mesh
    assert on["mesh"] == {"data": 1, "graph": 2, "backend": "gloo"}
    _same_run(on, off)


def test_fullysup_under_a_launcher_world_of_two(tiny):
    argv = ARGV + ["--device_data", "--augment_type_sup", "weak"]
    off = fullysup.run_training(parse_option(argv + ["--mesh", "off"]))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", LAUNCH, *argv],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              cwd=tiny, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "mesh: 2 devices" in outs[0] and "edge-sharded" in outs[0]
    # rank 1 prints nothing of the run (the CLI's parse still names the
    # save folder)
    assert "epoch 1" not in outs[1] and "Test set" not in outs[1]
    assert "epoch 1" in outs[0] and "Test set" in outs[0]
    folder = parse_option(argv).save_folder
    logs = [f for f in os.listdir(folder) if f.startswith("output_record_")]
    assert len(logs) == 1                 # rank 0 alone writes its log
    on = np.load(os.path.join(folder, "loss_acc_records.npy"),
                 allow_pickle=True).item()
    assert on["loader_backend"] == "device"
    _same_run(on, off)
    with pytest.raises(ValueError, match="world size 2"):
        os.environ.update(WORLD_SIZE="2")
        try:
            fullysup.run_training(parse_option(argv + ["--mesh", "3"]))
        finally:
            del os.environ["WORLD_SIZE"]
