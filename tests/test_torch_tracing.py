"""The port's spans and counters (``utils/profiling.py``): free when no
profiler records, nested as the layers are under one, and counting the
CG's iterations, the BSR plans and the host's waits for the device.

The card test holds ``host_syncs`` against the synchronizing CUDA calls a
profiled trace shows, so that no site where the host waits goes
uncounted.  This file imports neither JAX nor the JAX package; on a
machine without JAX:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from graphlearninglayer_tpu_torch.evalx.harness import \
    test_gl_transductive as gl_transductive
from graphlearninglayer_tpu_torch.ops import EvalGraphCache, transductive
from graphlearninglayer_tpu_torch.ops.solve import stable_conjgrad
from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                make_gl_train_step,
                                                metrics_to_host)
from graphlearninglayer_tpu_torch.train import adversarial_driver as ad
from graphlearninglayer_tpu_torch.utils import profiling

NUM_CLASSES, SHAPE = 4, (8, 8, 3)
NORM = ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))
SPANS = ("gl.encode", "gl.op.forward", "gl.op.knn", "gl.op.affinity",
         "gl.op.solve", "gl.op.backward", "gl.backward", "gl.update",
         "pgd.attack", "eval.encode", "eval.solve", "eval.knn", "eval.plan",
         "eval.cg", "eval.cg.check")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Tiny(nn.Module):
    """One stride-2 conv, a mean pool and a dense layer to 16 unit
    features, with a linear classifier beside them: ``(logits,
    features)``, as the port's BuildNet returns."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.conv = nn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.dense = nn.Linear(8, 16)
        self.head = nn.Linear(16, NUM_CLASSES)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)

    def forward(self, x):
        f = F.normalize(self.dense(torch.relu(self.conv(x)).mean((2, 3))),
                        dim=1)
        return self.head(f), f


def _images(n, seed, dev):
    """uint8 NHWC images around one prototype a class, and their labels:
    the classes cluster, so the eval's graph tiles."""
    rng = np.random.default_rng(seed)
    proto = rng.integers(40, 216, (NUM_CLASSES, *SHAPE))
    labels = rng.integers(0, NUM_CLASSES, n)
    noise = rng.integers(-30, 31, (n, *SHAPE))
    img = np.clip(proto[labels] + noise, 0, 255).astype(np.uint8)
    return torch.as_tensor(img, device=dev), labels


def _normalized(img):
    mean, std = (torch.tensor(v, device=img.device) for v in NORM)
    return (img.float() / 255.0 - mean) / std


def make_fullysup(dev):
    """One FullySup GL step (20 base + 40 batch rows, k 5) and the host
    read of its metrics, as a call; its inputs, model and optimizer are
    made on ``dev`` first."""
    img, labels = _images(60, 1, dev)
    x = _normalized(img)
    y = torch.as_tensor(labels, device=dev)
    state = create_train_state(Tiny(), lambda _: 0.01, device=dev)
    step = make_gl_train_step(NUM_CLASSES, tau=0.07, k=5, device=dev)

    def run():
        _, m, _ = step(state, x[:20], y[:20], x[20:], y[20:])
        return metrics_to_host(m)

    return run


def make_pgd(dev):
    """One robust GL step of the adversarial driver (5 PGD iterations and
    the update: six op calls) and the driver's read of its Cholesky
    infos, as a call."""
    img, labels = _images(60, 2, dev)
    x = _normalized(img).permute(0, 3, 1, 2).contiguous()
    y = torch.as_tensor(labels, device=dev)
    cfg = ad.AdvConfig("synthetic", "tiny", "tiny", -2.0, 2.0, 0.05, 40, 5,
                       0.01, 1, adam=True, gl_tau=1e-6)
    state = create_train_state(Tiny(), lambda _: 0.01, device=dev,
                               **ad._make_tx(cfg, "gl"))
    gen = torch.Generator(device=dev).manual_seed(3)
    lo, hi = (torch.tensor(v, device=dev) for v in (-2.0, 2.0))
    step = ad.make_train_step("gl", "robust", cfg, NUM_CLASSES, x[:20],
                              y[:20], gen, lo, hi, dev)

    def run():
        stats: list = []
        step(state, x[20:], y[20:], stats)
        return ad.max_chol_info(stats)

    return run


def make_eval(dev, cache=None, n=1100):
    """A resident transductive eval over ``n`` nodes (k 10) on its BSR
    route, as a call that returns its ``stats``."""
    img, labels = _images(n, 3, dev)
    flat = img.reshape(n, -1)
    n_test = n // 5
    train, test = flat[:-n_test], flat[-n_test:]
    base = np.concatenate([np.flatnonzero(labels[:-n_test] == c)[:3]
                           for c in range(NUM_CLASSES)])
    state = create_train_state(Tiny(), lambda _: 0.0, device=dev)

    def run():
        stats: dict = {}
        gl_transductive(state, base, labels[base], test, labels[-n_test:],
                        None, NUM_CLASSES, knn_num=10, norm=NORM,
                        resident=(train, test, base, SHAPE), cache=cache,
                        device=dev, stats=stats)
        return stats

    return run


PATHS = {"fullysup": make_fullysup, "pgd": make_pgd, "eval": make_eval}


def _syncs() -> int:
    return sum(profiling.host_syncs.values())


def _spans(events):
    """(name, start, end, parent) of each span event, the parent being the
    innermost span open over it on any thread."""
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in events if e.name in SPANS),
                   key=lambda s: (s[1], -s[2]))
    out = []
    for name, a, b in spans:
        outer = [s for s in spans if s[1] <= a and b <= s[2]
                 and s != (name, a, b)]
        parent = max(outer, key=lambda s: (s[1], -s[2]))[0] if outer \
            else None
        out.append((name, a, b, parent))
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_span_is_opened_without_a_profiler(path, monkeypatch):
    opened = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    run = PATHS[path]("cpu")
    iters, syncs = stable_conjgrad.iterations, _syncs()
    out = run()
    assert opened == []
    # the counters count all the same
    assert _syncs() > syncs
    if path == "eval":
        assert stable_conjgrad.iterations - iters == out["cg_iters"] > 0


def test_a_span_costs_a_flag_test_without_a_profiler():
    assert profiling.annotate("gl.encode") is profiling.annotate("eval.cg")


EXPECTED = {
    "fullysup": {("gl.encode", None): 1, ("gl.op.forward", None): 1,
                 ("gl.op.knn", "gl.op.forward"): 1,
                 ("gl.op.affinity", "gl.op.forward"): 1,
                 ("gl.op.solve", "gl.op.forward"): 1,
                 ("gl.update", None): 1, ("gl.backward", "gl.update"): 1,
                 ("gl.op.backward", "gl.backward"): 1},
    # five PGD iterations inside the attack, then the update's
    "pgd": {("pgd.attack", None): 1, ("gl.encode", "pgd.attack"): 5,
            ("gl.op.forward", "pgd.attack"): 5,
            ("gl.backward", "pgd.attack"): 5,
            ("gl.encode", None): 1, ("gl.op.forward", None): 1,
            ("gl.op.knn", "gl.op.forward"): 6,
            ("gl.op.affinity", "gl.op.forward"): 6,
            ("gl.op.solve", "gl.op.forward"): 6,
            ("gl.op.backward", "gl.backward"): 6,
            ("gl.update", None): 1, ("gl.backward", "gl.update"): 1},
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_as_the_layers_do(path):
    run = PATHS[path]("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    got: dict = {}
    for name, _, _, parent in _spans(prof.events()):
        got[(name, parent)] = got.get((name, parent), 0) + 1
    if path == "eval":
        expected = {("eval.encode", None): 1, ("eval.solve", None): 1,
                    ("eval.knn", "eval.solve"): 1,
                    ("eval.plan", "eval.solve"): 1,
                    ("eval.cg", "eval.solve"): 1,
                    ("eval.cg.check", "eval.cg"): out["cg_iters"] + 1}
    else:
        expected = EXPECTED[path]
    assert got == expected


def test_cg_counts_its_iterations_and_checks():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(30, 30, generator=gen, dtype=torch.float64)
    a = a @ a.T + 30 * torch.eye(30, dtype=torch.float64)
    b = torch.randn(30, 3, generator=gen, dtype=torch.float64)
    for max_iter in (100_000, 4):
        iters, checks = (stable_conjgrad.iterations,
                         profiling.host_syncs.get("solve.cg_check", 0))
        _, done, _ = stable_conjgrad(lambda p: a @ p, b, tol=1e-10,
                                     max_iter=max_iter, return_info=True)
        assert stable_conjgrad.iterations - iters == done
        # one check before each iteration, and one after the last unless
        # max_iter ends the solve
        assert (profiling.host_syncs["solve.cg_check"] - checks
                == done + (max_iter > done))
    assert done == 4


def test_host_syncs_of_an_eval_are_its_iterations_and_its_sites():
    run = make_eval("cpu", EvalGraphCache())
    for route, plan_sites in (("fresh", ("bsr.chain_distances",
                                         "bsr.chain_rank",
                                         "transductive.plan_stats")),
                              ("from_perm", ("transductive.plan_stats",))):
        plans = dict(transductive.bsr_plans)
        before = dict(profiling.host_syncs)
        stats = run()
        delta = {k: v - before.get(k, 0)
                 for k, v in profiling.host_syncs.items()
                 if v != before.get(k, 0)}
        sites = ("harness.base_rows", "harness.labels",
                 "transductive.finish", "harness.pred") + plan_sites
        # the train and the test rows are encoded in one batch each, and
        # each batch copies the mean and the std to the device
        assert delta == {"solve.cg_check": stats["cg_iters"] + 1,
                         "trainer.normalize_mean": 2,
                         "trainer.normalize_std": 2,
                         **{s: 1 for s in sites}}
        assert {k: v - plans[k] for k, v in transductive.bsr_plans.items()
                } == {r: int(r == route) for r in plans}


def _sync_calls(events, inside):
    """The synchronizing CUDA runtime calls of a trace that start in one of
    the (start, end) intervals ``inside``, each with the innermost span
    and the innermost host op open around it."""
    names = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
    span_list = [(n, a, b) for n, a, b, _ in _spans(events)]
    ops = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type.name == "CPU" and e.name.startswith("aten::")]

    def inner(intervals, t):
        around = [iv for iv in intervals if iv[1] <= t <= iv[2]]
        return max(around, key=lambda iv: (iv[1], -iv[2]))[0] if around \
            else None

    return [(e.name, inner(span_list, e.time_range.start),
             inner(ops, e.time_range.start)) for e in events
            if e.name in names and any(a <= e.time_range.start <= b
                                       for a, b in inside)]


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_host_syncs_match_the_trace_on_the_card(path):
    """The host_syncs delta of a profiled call on the card equals the
    synchronizing calls its trace shows: inside ``eval.encode`` and
    ``eval.solve`` for the eval (two evals, the second from the cache's
    permutation), inside the call for a train step and its read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    run = (make_eval("cuda", EvalGraphCache(), n=6000) if path == "eval"
           else PATHS[path]("cuda"))
    run()                                  # builds the kernels, warms up
    torch.cuda.synchronize()
    for _ in range(2 if path == "eval" else 1):
        syncs = _syncs()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("test.call"):
                run()
        delta = _syncs() - syncs
        events = prof.events()
        wanted = (("eval.encode", "eval.solve") if path == "eval"
                  else ("test.call",))
        inside = [(e.time_range.start, e.time_range.end) for e in events
                  if e.name in wanted and e.device_type.name == "CPU"]
        calls = _sync_calls(events, inside)
        tally: dict = {}
        for c in calls:
            tally[c] = tally.get(c, 0) + 1
        print(path, "host_syncs", delta, "trace", len(calls), tally)
        assert delta == len(calls), tally
