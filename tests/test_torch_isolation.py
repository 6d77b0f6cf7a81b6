"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and its entry points run on the card unless told otherwise."""
import ast
import pathlib

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
    return files + [ROOT / "chip_smoke.py"]


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
                "evalx/visualize", "train/fullysup"):
        assert f"graphlearninglayer_tpu_torch/{mod}.py" in names, mod
    assert len(files) >= 30
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
