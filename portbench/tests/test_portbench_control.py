"""`correct` comes out false for the control and for each fault a cell can
have, at a tiny size on the CPU under the cells' own limits.

The control is the reference put in the program's place in the precision
below the configuration's: bfloat16 for the TF32 encoder, and for the eval
TF32 products in the float32 solve.  The faults are planted in the
program underneath a whole run (set-up, window, comparison): a step that
leaves its state unchanged, a loss over half the batch, an answer altered
where the harness receives it."""
import json

import pytest
import torch

from portbench import run
from portbench.common import check

BENCH = json.loads((run.REPO / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, tiny):
    r = run.resolve(BENCH, cell, overrides=tiny[cell])
    s = r["session"].Session(r["cfg"], r["traffic"], r["encoder"], 2**31 + 9,
                             "cpu")
    ok, shown = check.verdict(s.judge(s.variants()["control"]()),
                              r["limits"])
    assert not ok, shown


def _half_batch(monkeypatch, module):
    loss = module.custom_ce_loss

    def half(scores, targets):
        h = len(targets) // 2
        return loss(scores[:h], targets[:h])

    monkeypatch.setattr(module, "custom_ce_loss", half)


def _frozen(monkeypatch, optimizer):
    monkeypatch.setattr(optimizer, "step", lambda self, closure=None: None)


def _altered(monkeypatch):
    from graphlearninglayer_tpu_torch.evalx import harness

    solve = harness.transductive_laplace

    def altered(*args, **kw):
        u, *rest = solve(*args, **kw)
        u = u.clone()
        u[0] = u[0].flip(0)
        return (u, *rest)

    monkeypatch.setattr(harness, "transductive_laplace", altered)


def _plant(name, monkeypatch):
    from graphlearninglayer_tpu_torch.train import adversarial_driver, trainer

    {"train_half_batch": lambda: _half_batch(monkeypatch, trainer),
     "train_frozen": lambda: _frozen(monkeypatch, torch.optim.SGD),
     "pgd_half_batch": lambda: _half_batch(monkeypatch, adversarial_driver),
     "pgd_frozen": lambda: _frozen(monkeypatch, torch.optim.Adam),
     "eval_altered": lambda: _altered(monkeypatch)}[name]()


@pytest.mark.parametrize("cell, fault", [
    ("c10_r18_gl.train", "train_half_batch"),
    ("c10_r18_gl.train", "train_frozen"),
    ("fmnist_r18_pgd.train", "pgd_half_batch"),
    ("fmnist_r18_pgd.train", "pgd_frozen"),
    ("c10_r18_gl.eval60k", "eval_altered"),
])
def test_a_planted_fault_is_not_correct(cell, fault, tiny, monkeypatch):
    _plant(fault, monkeypatch)
    res = run.run_cell(cell, 2**31 + 13, 0.3, False, device="cpu",
                       overrides=tiny[cell], setup_clock=lambda: 0.0)
    assert not res["correct"], res["checked"]
