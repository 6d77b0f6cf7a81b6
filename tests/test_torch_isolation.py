"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and its entry points run on the card unless told otherwise."""
import ast
import pathlib

import pytest
import torch

from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                make_gl_eval_step,
                                                make_gl_train_step,
                                                make_lr_schedule)

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
    assert len(files) >= 20
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_gl_train_step(4, tau=0.07)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_gl_eval_step(4, tau=0.07)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(BuildNet("resnet18"),
                           make_lr_schedule(0.01, 1, 1))
    # the CPU is used only when asked for
    assert callable(make_gl_train_step(4, tau=0.07, device="cpu"))
    assert callable(make_gl_eval_step(4, tau=0.07, device="cpu"))
    state = create_train_state(BuildNet("resnet18"),
                               make_lr_schedule(0.01, 1, 1), device="cpu")
    assert next(state.model.parameters()).device.type == "cpu"
