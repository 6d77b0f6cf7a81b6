"""The port's CLI (``config/cli.py``) against the JAX package's: the same
argv gives the same Namespace, derived options included, apart from the two
deliberate differences (``--dev`` is the torch device, default 'cuda';
``--mesh`` takes only 'auto', 'off' or a positive count)."""
import pytest

from graphlearninglayer_tpu.config.cli import parse_option as jparse
from graphlearninglayer_tpu_torch.config.cli import parse_option as tparse


ARGVS = [
    [],
    ["--sup_train_type", "gl", "--dataset", "cifar10", "--cosine",
     "--epsilon", "auto", "--batch_size", "1250", "--knn_k", "25"],
    ["--sup_train_type", "mlp", "--warm", "--cosine", "--epochs", "40",
     "--learning_rate", "0.05", "--train_prefix", "run"],
    ["--warm", "--lr_decay_epochs", "10,20", "--epsilon", "0.5",
     "--start_epochs", "3", "--epochs", "5", "--cp_load_path", "ckpt"],
    ["--dataset", "synthetic", "--synth_sep", "1.5", "--synth_n_train",
     "96", "--gl_solver", "cg", "--mesh", "off", "--bf16",
     "--ds_stepsize", "3", "--no_eval_cache", "--grad_warn", "0"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_same_namespace_as_jax(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    want = vars(jparse(argv))
    got = vars(tparse(argv))
    assert want.pop("dev") == "tpu" and got.pop("dev") == "cuda"
    assert got == want
    assert (tmp_path / got["save_folder"]).is_dir()
    assert vars(tparse(argv + ["--dev", "cpu"]))["dev"] == "cpu"


def test_dev_and_mesh_choices(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert tparse(["--mesh", "1"]).mesh == "1"
    for bad in (["--mesh", "all"], ["--mesh", "0"], ["--dev", "tpu"]):
        with pytest.raises(SystemExit):
            tparse(bad)
    assert "--mesh takes" in capsys.readouterr().err
