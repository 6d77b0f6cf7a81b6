"""The port's meters and profiling hooks (``utils/meters.py``,
``utils/profiling.py``) against the JAX package's, on the same inputs:
exact equality of every value (the same arithmetic on the host)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from graphlearninglayer_tpu.models import BuildNet as JBuildNet
from graphlearninglayer_tpu.utils import meters as jm
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.utils import meters as tm
from graphlearninglayer_tpu_torch.utils import profiling


def test_meters_match_jax(tmp_path, capsys):
    vals = [(0.5, 3), (1.25, 1), (0.75, 4)]
    a, b = tm.AverageMeter(), jm.AverageMeter()
    sa, sb = tm.AverageMeterSet(), jm.AverageMeterSet()
    for v, n in vals:
        a.update(v, n)
        b.update(v, n)
        sa.update("loss", v, n)
        sb.update("loss", v, n)
    assert vars(a) == vars(b)
    for fn in ("values", "averages", "sums", "counts"):
        assert getattr(sa, fn)() == getattr(sb, fn)()
    out = np.random.default_rng(0).normal(size=(20, 6))
    target = np.random.default_rng(1).integers(0, 6, 20)
    assert tm.topk_accuracy(out, target, (1, 3)) == jm.topk_accuracy(
        out, target, (1, 3))
    groups = [np.arange(5), np.arange(5, 7), np.array([], int),
              np.arange(7, 20)]
    np.testing.assert_array_equal(
        tm.UnifLabelSampler(17, groups, seed=3).generate_indexes_epoch(),
        jm.UnifLabelSampler(17, groups, seed=3).generate_indexes_epoch())
    assert len(tm.UnifLabelSampler(17, groups)) == 17

    tp = tm.Throughput(edges_per_step=10)
    tp.step(4)
    assert tp.steps_per_s > 0 and tp.edges_per_s > 0

    log = tm.FileLogger(str(tmp_path / "record.txt"))
    log.write("tee line\n")
    log.flush()
    log.close()
    assert "tee line" in capsys.readouterr().out
    assert (tmp_path / "record.txt").read_text() == "tee line\n"


def test_parameter_count_matches_jax():
    jmodel = JBuildNet(name="resnet18", head="mlp", feat_dim=16,
                       num_classes=4)
    shapes = jax.eval_shape(
        lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(0)}, x,
                              train=False), jnp.zeros((1, 8, 8, 3)))
    model = BuildNet("resnet18", head="mlp", feat_dim=16, num_classes=4)
    assert tm.parameter_count(model) == jm.parameter_count(shapes["params"])
    table = tm.parameters_string(model)
    assert table.splitlines()[-1].split()[-1] == \
        f"{tm.parameter_count(model):,d}"


def test_trace_steps_writes_a_chrome_trace(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    with profiling.trace_steps(str(trace_dir), enabled=False):
        torch.ones(4).sum()
    assert not trace_dir.exists()
    with profiling.trace_steps(str(trace_dir)):
        with profiling.annotate("phase_a"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (file,) = os.listdir(trace_dir)
    events = json.loads((trace_dir / file).read_text())["traceEvents"]
    assert any(e.get("name") == "phase_a" for e in events)
    assert "profiler trace written to" in capsys.readouterr().out
