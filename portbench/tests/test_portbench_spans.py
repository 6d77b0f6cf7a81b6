"""common/spans.py on hand-built records, and the readers of the program's
spans and counters: a kernel goes to the innermost span open at its
launch on any thread, a span's idle time is its interval less the kernels'
union, and every reader finds nothing where its span or counter is
absent."""
import importlib.util
from pathlib import Path

import pytest
import torch

from portbench.common import profile, spans

METRICS = Path(spans.__file__).resolve().parents[1] / "metrics"
NEW = ("op_span_ms.train", "encoder_span_ms.train", "update_span_ms.train",
       "host_syncs.train", "cg_iter_ms.eval", "cg_idle_pct.eval",
       "plan_ms.eval", "host_syncs.eval")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_a_kernel_goes_to_the_innermost_span_at_its_launch():
    # the update on the main thread holds the backward, whose op backward
    # runs on autograd's thread (its own span, inside in time)
    span_list = [("gl.update", 0, 100), ("gl.backward", 10, 80),
                 ("gl.op.backward", 30, 50), ("gl.encode", 200, 300)]
    launches = {1: 5, 2: 20, 3: 40, 4: 60, 5: 150, 6: 250}
    # device times lag the launches, and overlap other spans' host times
    kernels = [(1, 105, 106), (2, 106, 110), (3, 110, 130), (4, 130, 131),
               (5, 200, 204), (6, 300, 310), (7, 320, 321)]
    t = spans.table(span_list, launches, kernels)
    got = {n: round(r["device_s"] * 1e6, 6) for n, r in t.items()}
    assert got == {"gl.update": 1.0, "gl.backward": 5.0,
                   "gl.op.backward": 20.0, "gl.encode": 10.0,
                   # launched between spans, and with no launch record
                   spans.OUTSIDE: 5.0}
    assert t["gl.update"]["host_s"] == pytest.approx(100e-6)
    assert t["gl.update"]["count"] == 1


def test_of_two_spans_that_open_together_the_shorter_is_inner():
    span_list = [("eval.solve", 0, 100), ("eval.cg", 0, 40)]
    assert spans.innermost(span_list, [10, 50, 150]) == [1, 0, None]


def test_idle_is_the_interval_less_the_union_of_kernels():
    span_list = [("eval.cg", 0, 100), ("eval.cg", 200, 260),
                 ("eval.cg.check", 90, 100)]
    # overlapping kernels count once; a kernel may start before the span
    kernels = [(1, -10, 20), (2, 10, 30), (3, 50, 60), (4, 95, 210)]
    t = spans.table(span_list, {}, kernels)
    # eval.cg: 100 - (30 + 10 + 5) and 60 - 10
    assert t["eval.cg"]["idle_s"] == pytest.approx((55 + 50) * 1e-6)
    assert t["eval.cg.check"]["idle_s"] == pytest.approx(5e-6)
    assert t["eval.cg"]["host_s"] == pytest.approx(160e-6)
    assert t["eval.cg"]["count"] == 2


def test_records_keep_spans_launches_and_device_work():
    class E:
        def __init__(self, name, dev, start, end, eid, user=False):
            self.name, self.device_type, self.id = name, dev, eid
            self.time_range = type("R", (), {"start": start, "end": end})
            self.is_user_annotation = user

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [E("step", cpu, 0, 50, 1, True), E("step", cuda, 5, 40, 1, True),
              E("gl.encode", cpu, 1, 20, 2), E("aten::mm", cpu, 2, 9, 3),
              E("cudaLaunchKernel", cpu, 3, 4, 11),
              E("cuLaunchKernelEx", cpu, 5, 6, 12),
              E("gemm_kernel", cuda, 10, 20, 11),
              E("Memcpy DtoH (Device -> Pinned)", cuda, 21, 22, 12)]
    s, launches, kernels = spans.records(events)
    assert s == [("gl.encode", 1, 20)]
    assert launches == {11: 3, 12: 5}
    assert kernels == [(11, 10, 20), (12, 21, 22)]


def _ctx(unit, table=None, counters=None, steps=2):
    prof = {"busy_s": 1.0, "window_s": 2.0, "group_s": {}}
    if table is not None:
        prof["spans"] = table
    if counters is not None:
        prof["counters"] = counters
    return {"unit": unit, "profile": prof, "steps": steps}


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_finds_nothing_without_its_span_or_counter(name):
    read = reader(name)
    unit = name.rsplit(".", 1)[1]
    # a program before the spans: the keys are missing, or the table
    # holds the kernels outside any span alone and no counter moved
    assert read(_ctx(unit)) is None
    outside = {spans.OUTSIDE: {"count": 0, "host_s": 0.0, "device_s": 1.0,
                               "idle_s": 0.0}}
    assert read(_ctx(unit, outside, {})) is None
    assert read(_ctx("eval" if unit == "train" else "train", outside,
                     {"host_syncs": 3})) is None


def _row(host, device, idle=0.0):
    return {"count": 1, "host_s": host, "device_s": device, "idle_s": idle}


def test_the_readers_read_the_table_and_the_counters():
    train = _ctx("train", {"gl.encode": _row(0.01, 0.030),
                           "gl.op.forward": _row(0.002, 0.001),
                           "gl.op.knn": _row(0.001, 0.0005),
                           "gl.op.backward": _row(0.001, 0.002),
                           "gl.backward": _row(0.02, 0.040),
                           "gl.update": _row(0.005, 0.004),
                           spans.OUTSIDE: _row(0.0, 0.001)},
                 {"host_syncs": 0, "cg_iterations": 0})
    assert reader("op_span_ms.train")(train) == pytest.approx(1.75)
    assert reader("encoder_span_ms.train")(train) == pytest.approx(35.0)
    assert reader("update_span_ms.train")(train) == pytest.approx(2.0)
    assert reader("host_syncs.train")(train) == 0
    ev = _ctx("eval", {"eval.cg": _row(0.3, 0.2, 0.09),
                       "eval.plan": _row(0.04, 0.01)},
              {"host_syncs": 190, "cg_iterations": 150})
    assert reader("cg_iter_ms.eval")(ev) == pytest.approx(2.0)
    assert reader("cg_idle_pct.eval")(ev) == pytest.approx(30.0)
    assert reader("plan_ms.eval")(ev) == pytest.approx(20.0)
    assert reader("host_syncs.eval")(ev) == 95


def test_the_window_keeps_its_keys_and_gains_the_spans(monkeypatch):
    """The wrapped profile_window returns the original's result as it
    was, plus the span table of the trace it made and the counters'
    changes over it (here a profile of the CPU and a small CG solve)."""
    from graphlearninglayer_tpu_torch.ops.solve import stable_conjgrad

    def window(run, steps, groups=profile.PROFILE_GROUPS, phase="step"):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(steps):
                run()
        return {"window_s": 1.0, "steps": steps}

    monkeypatch.setattr(profile, "profile_window", window)
    spans.install()
    assert profile.profile_window is not window
    a = torch.eye(8, dtype=torch.float64) * 2.0
    b = torch.ones(8, 2, dtype=torch.float64)
    out = profile.profile_window(lambda: stable_conjgrad(lambda p: a @ p, b),
                                 3)
    assert out["window_s"] == 1.0 and out["steps"] == 3
    # one iteration a solve, two checks
    assert out["counters"]["cg_iterations"] == 3
    assert out["counters"]["host_syncs.solve.cg_check"] == 6
    assert out["spans"]["eval.cg.check"]["count"] == 6
    # installing twice wraps once
    wrapped = profile.profile_window
    spans.install()
    assert profile.profile_window is wrapped
