"""The numbers that decide `correct`, and the window loops.

Each number is a gap between what the subject (the program, or the
reference put in its place in a lower precision or with a planted fault)
produced and what the float32 / float64 reference works out, and is held
against a limit from the cell's file under ``limits/``.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from ..reference import laplace
from ..reference import train as ref_train

# a leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by rounding alone; its change is not compared
MOVED_SHARE = 1e-3


def loss_gap(subject, reference) -> float:
    """max_t |s_t - r_t| / |r_1| over the steps' losses: each step's gap on
    the scale of the first step's loss, as a loss that falls towards 0
    would make a gap relative to its own step swing with its size."""
    return max(abs(s - r) for s, r in zip(subject, reference)) \
        / abs(reference[0])


def _norms(leaves: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in leaves.items()}


def leaf_gap(subject: dict, reference: dict, names=None) -> float:
    """The worst leaf's | |s| - |r| | / max(|r|, the median leaf's |r|):
    the gap between the norms, not the norm of the difference."""
    s, r = _norms(subject), _norms(reference)
    names = list(r) if names is None else list(names)
    med = statistics.median(r[n] for n in r)
    return max(abs(s[n] - r[n]) / max(r[n], med) for n in names)


def moved(grads: dict) -> list:
    """The leaves whose reference gradient is at least MOVED_SHARE of the
    median leaf's."""
    g = _norms(grads)
    med = statistics.median(g.values())
    return [n for n, v in g.items() if v >= MOVED_SHARE * med]


def feat_gap(subject: torch.Tensor, reference: torch.Tensor) -> float:
    """The worst row's |f - f_ref| of unit-norm features."""
    return float(torch.linalg.vector_norm(
        subject.double() - reference.double(), dim=1).max())


def knn_gap(f: torch.Tensor, nbr: torch.Tensor) -> float:
    """How far the lists ``nbr`` of features ``f`` are from exact: the
    worst excess of the list's d2 at a rank over the exact list's d2 at
    that rank, both in float64 from ``f`` (d2 of unit vectors, so that the
    ranking's rounding reads alike at every spread); inf where a list does
    not start with its row or repeats a row."""
    d2 = laplace.edge_d2(f.double(), nbr)
    _, exact = laplace.knn_lists(f, nbr.shape[1])
    srt = torch.sort(nbr, dim=1).values
    valid = ((srt[:, 1:] != srt[:, :-1]).all(dim=1)
             & (nbr[:, 0] == torch.arange(len(nbr), device=nbr.device)))
    if not bool(valid.all()):
        return float("inf")
    return float((torch.sort(d2, dim=1).values - exact).max())


def fed_gap(fed, features, cfg: dict) -> float:
    """The worst :func:`feat_gap` over every encoder call a subject kept,
    each (parameters and buffers, images, features, train mode): its
    features against the float32 reference encoder's ``features`` from
    the same parameters, buffers and images, in the same mode."""
    worst = 0.0
    with torch.no_grad():
        for p, x, f, train in fed:
            with ref_train.precision("float32", x.device):
                ref = features(p, x, cfg, train).float()
            worst = max(worst, feat_gap(f, ref))
    return worst


def train_numbers(subject: dict, reference: dict, features,
                  cfg: dict) -> dict:
    """The compared numbers of three train steps: each step's loss, the
    first gradient, the change after three steps, the features of every
    encoder call in them, and every neighbour list the subject's layer
    ran on."""
    return {
        "loss_gap": loss_gap(subject["losses"], reference["losses"]),
        "grad_gap": leaf_gap(subject["grad"], reference["grad"]),
        "update_gap": leaf_gap(subject["change"], reference["change"],
                               moved(reference["grad"])),
        "feat_gap": fed_gap(subject["fed"], features, cfg),
        "knn_gap": max(knn_gap(f, nbr) for f, nbr in subject["used"]),
    }


class Tap:
    """Wraps ``module.name`` so that each call's arguments and result are
    kept (``keep_all``: every call's results, else the latest call's) and
    the calls counted; :meth:`close` puts the original back."""

    def __init__(self, module, name: str, keep_all: bool = False):
        self.module, self.name, self.keep_all = module, name, keep_all
        self.fn = getattr(module, name)
        self.args = self.out = None
        self.outs: list = []
        self.calls = 0
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        self.out = self.fn(*args, **kw)
        self.args = args
        self.calls += 1
        if self.keep_all:
            self.outs.append(self.out)
        return self.out

    def close(self):
        setattr(self.module, self.name, self.fn)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    ok = all(math.isfinite(numbers[n]) and numbers[n] <= limits[n]
             for n in limits)
    shown = {n: {"value": numbers[n] if math.isfinite(numbers[n])
                 else str(numbers[n]), "limit": limits[n]} for n in limits}
    return ok, shown


def timed_steps(step, seconds: float, device) -> dict:
    """``step()`` back to back for ``seconds`` of host time, with a CUDA
    event recorded between steps and no host sync until the window
    closes; each step's time is read from the events after it.  On the
    CPU (the harness's tests) the host clock times each step."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        marks = [t0]
        while marks[-1] - t0 < seconds:
            step()
            marks.append(time.perf_counter())
        return {"steps": len(marks) - 1, "window_s": marks[-1] - t0,
                "step_ms": [1e3 * (b - a) for a, b in zip(marks, marks[1:])]}
    events = [torch.cuda.Event(enable_timing=True)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    while True:
        step()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if time.perf_counter() - t0 >= seconds:
            break
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"steps": len(step_ms), "window_s": window, "step_ms": step_ms}


def timed_calls(call, seconds: float, device, min_calls: int = 1) -> dict:
    """``call()`` (work that ends in a host sync of its own) back to back
    for ``seconds`` and at least ``min_calls`` times; the window ends in a
    device sync."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    n = 0
    while n < min_calls or time.perf_counter() - t0 < seconds:
        call()
        n += 1
    sync()
    return {"calls": n, "window_s": time.perf_counter() - t0}
