"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and its entry points run on the card unless told otherwise."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from graphlearninglayer_tpu_torch.evalx import harness
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.train import (create_train_state, fullysup,
                                                make_gl_eval_step,
                                                make_gl_train_step,
                                                make_lr_schedule,
                                                make_mlp_eval_step,
                                                make_mlp_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "graphlearninglayer_tpu")


def _port_files():
    files = sorted((ROOT / "graphlearninglayer_tpu_torch").rglob("*.py"))
    # tests/torch_ranks.py runs in the spawned ranks of the multi-rank
    # tests, which import no JAX
    return files + [ROOT / "chip_smoke.py", ROOT / "k1_turns.py",
                    ROOT / "k2_turns.py", ROOT / "p3_turns.py",
                    ROOT / "probes_turns.py",
                    ROOT / "mnist_fgsm_probe.py",
                    ROOT / "parallel_probe.py",
                    ROOT / "tests" / "torch_ranks.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax():
    files = _port_files()
    names = {p.relative_to(ROOT).as_posix() for p in files}
    # the driver slice's modules are scanned too
    for mod in ("config/cli", "data/augment", "data/native", "data/pipeline",
                "utils/meters", "utils/checkpoint", "utils/profiling",
                "evalx/visualize", "train/fullysup",
                # the encoder zoo and the adversarial path
                "models/cnn", "models/preact_resnet", "models/wrn",
                "models/resnet_mnist", "utils/jax_params", "attack/fgsm",
                "attack/pgd", "attack/cw", "attack/driver",
                "train/adversarial_driver",
                # the remaining drivers and the device-resident data
                "data/device_aug", "data/pseudo_label",
                "train/compare_to_mlp", "train/supcon",
                # the banded KNN and the multi-device package
                "ops/knn_banded", "parallel/__init__", "parallel/mesh",
                "parallel/multihost", "parallel/graph_shard",
                "parallel/edge_shard",
                # the entry points
                "entry"):
        assert f"graphlearninglayer_tpu_torch/{mod}.py" in names, mod
    assert len(files) >= 40
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the CLI makes its save folder
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_gl_train_step(4, tau=0.07)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_gl_eval_step(4, tau=0.07)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(BuildNet("resnet18"),
                           make_lr_schedule(0.01, 1, 1))
    for make in (make_mlp_train_step, make_mlp_eval_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.test_network(None, [], [], [], [], 4, 0.07)
    with pytest.raises(RuntimeError, match="--dev cpu"):
        fullysup.main(["--sup_train_type", "gl", "--dataset", "synthetic"])
    # the CPU is used only when asked for
    assert callable(make_gl_train_step(4, tau=0.07, device="cpu"))
    assert callable(make_gl_eval_step(4, tau=0.07, device="cpu"))
    state = create_train_state(BuildNet("resnet18"),
                               make_lr_schedule(0.01, 1, 1), device="cpu")
    assert next(state.model.parameters()).device.type == "cpu"


def test_adversarial_entry_points_raise_without_cuda(no_cuda, tmp_path,
                                                    monkeypatch):
    """The adversarial path's drivers and attack builders run on the card
    unless given the CPU, and raise without CUDA before any work."""
    from graphlearninglayer_tpu_torch import attack
    from graphlearninglayer_tpu_torch.attack import driver, pgd
    from graphlearninglayer_tpu_torch.train import adversarial_driver

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adversarial_driver.run("gl", "robust", "synthetic")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.run("fgsm", "gl", "robust", "synthetic")
    with pytest.raises(RuntimeError, match="--dev cpu"):
        adversarial_driver.main(["gl", "robust", "synthetic"])
    with pytest.raises(RuntimeError, match="--dev cpu"):
        driver.main(["fgsm", "gl", "robust", "synthetic"])
    gl = [lambda **kw: attack.make_gl_fast_gradient_attack(None, 3, **kw),
          lambda **kw: attack.make_gl_cw_attack(None, 3, **kw),
          lambda **kw: attack.make_gl_pgd_perturb(None, 3, **kw),
          lambda **kw: pgd.make_gl_pgd_perturb_p(None, 3, **kw)]
    mlp = [lambda **kw: attack.make_mlp_fast_gradient_attack(None, **kw),
           lambda **kw: attack.make_mlp_cw_attack(None, **kw),
           lambda **kw: attack.make_mlp_pgd_perturb(None, **kw),
           lambda **kw: pgd.make_mlp_pgd_perturb_p(None, **kw)]
    for make in gl + mlp:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert callable(make(device="cpu"))
    assert not (tmp_path / "models").exists()


def test_remaining_drivers_raise_without_cuda(no_cuda, tmp_path,
                                             monkeypatch):
    """The compare, SupCon and visualize CLIs, the from-data steps and the
    resident encode run on the card unless given the CPU, and raise
    without CUDA before any work."""
    import importlib

    from graphlearninglayer_tpu_torch.train import (
        compare_to_mlp, make_encode_step_from_data,
        make_gl_train_step_from_data, make_mlp_train_step_from_data,
        supcon)

    viz = importlib.import_module(
        "graphlearninglayer_tpu_torch.evalx.visualize")
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "synthetic"]
    for main in (compare_to_mlp.main, supcon.main):
        with pytest.raises(RuntimeError, match="--dev cpu"):
            main(argv)
    with pytest.raises(RuntimeError, match="--dev cpu"):
        fullysup.main(["--sup_train_type", "gl", "--device_data"] + argv)
    with pytest.raises(RuntimeError, match="--dev cpu"):
        viz.main([str(tmp_path / "ckpt")] + argv)
    makes = [lambda **kw: make_gl_train_step_from_data(4, (8, 8, 3), 0.07,
                                                       **kw),
             lambda **kw: make_mlp_train_step_from_data((8, 8, 3), **kw),
             lambda **kw: make_encode_step_from_data((8, 8, 3), 4, **kw),
             lambda **kw: supcon.make_supcon_step(0.07, **kw),
             lambda **kw: compare_to_mlp.make_compare_step(
                 4, np.zeros((1, 8, 8, 3), np.float32), [0], 0.07, **kw)]
    for make in makes:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert callable(make(device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.encode_dataset_resident(None, None, 4, (8, 8, 3), None)


def test_multidevice_entry_points_raise_without_cuda(no_cuda, tmp_path,
                                                     monkeypatch):
    """A mesh and a rank run on the card unless given the CPU, and raise
    without CUDA; so does the driver's --mesh."""
    from graphlearninglayer_tpu_torch.parallel import (initialize_multihost,
                                                       make_mesh)

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_multihost("file://" + str(tmp_path / "store"), 1, 0)
    with pytest.raises(RuntimeError, match="--dev cpu"):
        fullysup.main(["--sup_train_type", "gl", "--dataset", "synthetic",
                       "--mesh", "2"])
    assert make_mesh(1, device="cpu").device.type == "cpu"
    assert not initialize_multihost()        # no launcher: one process


def test_entry_and_dryrun_raise_without_cuda(no_cuda, tmp_path, monkeypatch):
    """entry(), its CLI, dryrun_multichip(n) and the sharded attack run on
    the card unless given the CPU, and raise without CUDA before any
    work (the dry run before it spawns a rank)."""
    from graphlearninglayer_tpu_torch import entry
    from graphlearninglayer_tpu_torch.attack import (
        make_sharded_gl_fast_gradient_attack)
    from graphlearninglayer_tpu_torch.parallel import Mesh, make_mesh

    monkeypatch.chdir(tmp_path)
    spawned = []
    monkeypatch.setattr("graphlearninglayer_tpu_torch.parallel.spawn_ranks",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.entry()
    with pytest.raises(RuntimeError, match="--dev cpu"):
        entry.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(2)
    assert not spawned
    card_mesh = Mesh(("data",), np.arange(1), "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sharded_gl_fast_gradient_attack(None, 3, card_mesh)
    # the CPU is used only when asked for
    forward, (model, images, _) = entry.entry(device="cpu", base_n=10,
                                              batch_n=10)
    assert images.device.type == "cpu" and callable(forward)
    entry.dryrun_multichip(2, device="cpu")
    assert len(spawned) == 1
    assert callable(make_sharded_gl_fast_gradient_attack(
        None, 3, make_mesh(1, device="cpu")))
