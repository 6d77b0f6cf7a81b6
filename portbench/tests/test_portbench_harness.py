"""The harness on the CPU: names resolve, BENCHMARK.json's format holds,
inputs repeat from the seed, a run without a card fails, the last line's
keys, and the reference agrees with the port's CPU path at a tiny size."""
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.common import inputs

REPO = Path(run.__file__).resolve().parents[1]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_benchmark_json_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in BENCH["workloads"]:
        assert c["chips"] == 1 and len(c["why"]) <= 200
        reported = [m for m in BENCH["end_to_end"]
                    if c["name"] in m.get("workloads", [c["name"]])]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        moves = {m["name"] for m in reported}
        layer = [m for m in BENCH["per_layer"]
                 if c["name"] in m.get("workloads", CELLS)]
        assert layer and all(m["moves"] in moves for m in layer)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {
            "name", "unit", "better", "source", "layer", "moves",
            "workloads"}


@pytest.mark.parametrize("cell", CELLS)
def test_every_name_resolves_to_its_files(cell):
    r = run.resolve(BENCH, cell)
    assert r["cfg"]["reduced"] == []
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == r["cell"]["config"])
    assert entry["reduced"] == r["cfg"]["reduced"]
    assert hasattr(r["encoder"], "program_model")
    assert hasattr(r["session"], "Session") and r["limits"]
    assert set(r["readers"]) == {m["name"] for m in r["per_layer"]}


def test_a_new_cell_is_new_files_and_an_entry(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    base = tmp_path / "portbench"
    (base / "traffic" / "gl_train_short.json").write_text(json.dumps(
        {**json.loads((base / "traffic" / "gl_train_fixed.json")
                      .read_text()), "warmup_steps": 2}))
    (base / "limits" / "c10_r18_gl.short.json").write_text(
        (base / "limits" / "c10_r18_gl.train.json").read_text())
    (base / "metrics" / "steps_traced.train.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    bench["workloads"].append({"name": "c10_r18_gl.short",
                               "config": "c10_r18_gl",
                               "traffic": "gl_train_short", "chips": 1,
                               "why": "a test entry"})
    bench["per_layer"].append({"name": "steps_traced.train", "unit": "1",
                               "better": "higher", "source": "program_span",
                               "layer": "whole step",
                               "moves": "train_images_per_s",
                               "workloads": ["c10_r18_gl.short"]})
    for m in bench["end_to_end"]:
        if "c10_r18_gl.train" in m.get("workloads", []):
            m["workloads"].append("c10_r18_gl.short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run.resolve(bench, "c10_r18_gl.short", tmp_path)
    assert r["traffic"]["warmup_steps"] == 2
    assert r["readers"]["steps_traced.train"].read({"steps": 3}) == 3.0


def test_inputs_repeat_from_the_seed():
    def draw(seed):
        g = inputs.generator(seed, "cpu")
        return inputs.synthetic_images(50, (8, 8, 3), 10, g, "cpu")

    (a, la), (b, lb), (c, _) = draw(2**31 + 5), draw(2**31 + 5), draw(7)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("cell", CELLS)
def test_session_orders_repeat_from_the_seed(cell, tiny):
    r = run.resolve(BENCH, cell, overrides=tiny[cell])

    def rows(seed):
        s = r["session"].Session(r["cfg"], r["traffic"], r["encoder"], seed,
                                 "cpu")
        if s.unit == "eval":
            return torch.as_tensor(s.draw_base()), s.sample, s.weights.flat
        s.draw_check_rows()
        return torch.cat(s.check_rows), s.base_y, s.weights.flat

    for x, y in zip(rows(2**31 + 11), rows(2**31 + 11)):
        assert (x == y) if isinstance(x, int) else torch.equal(x, y)


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_on_the_cpu_agrees_with_the_reference(cell, tiny):
    res = run.run_cell(cell, 2**31 + 3, 0.5, False, device="cpu",
                       overrides=tiny[cell], setup_clock=lambda: 0.0)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checked"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    # a CPU run never names itself a device
    assert res["device"]["platform"] == "cpu"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == e2e
    for name, v in res["checked"].items():
        # the port's CPU path in float32 against the float64 reference
        assert v["value"] <= v["limit"] / 3, (name, v)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_one_short_run_on_the_card(cell, cuda_device):
    res = run.run_cell(cell, 2**31 + 17, 2.0, False, device=cuda_device)
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
