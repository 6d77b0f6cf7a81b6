"""The program's own spans and counters, read from a traced window.

The port opens a span at each layer boundary (``gl.encode``, ``gl.op.*``,
``gl.backward``, ``gl.update``, ``pgd.attack``, ``eval.*``; the list is in
``graphlearninglayer_tpu_torch/utils/profiling.py``) and keeps counters
beside them (``host_syncs``, ``stable_conjgrad.iterations``,
``bsr_plans``).  This module turns a profiler trace into a table by span
name:

* ``host_s``: the span's host seconds, every interval of the name summed;
* ``device_s``: the device seconds of the kernels (and copies) launched
  while the span was the innermost span open, on any thread: a kernel
  belongs to the narrowest span around the host call that launched it
  (the CUDA runtime call of the same correlation id), not to its name;
* ``idle_s``: the seconds of the span's intervals in which no kernel ran
  on the device;
* ``count``: its intervals.

Kernels launched inside no span go to ``OUTSIDE``.  :func:`install` makes
``common/profile.py``'s ``profile_window`` return two more keys, computed
from the same trace: ``spans``, the table, and ``counters``, each
counter's change over the window.  The keys it already returned are the
original function's, computed as before.  Where the program has no spans
or counters (a commit before them), the table holds ``OUTSIDE`` alone and
``counters`` is empty, and the readers find nothing to read.
"""
from __future__ import annotations

import re

import numpy as np

from . import profile as _profile

SPAN_PREFIXES = ("gl.", "eval.", "pgd.")
OUTSIDE = "(outside)"
# a CUDA runtime or driver call: the host side of a launch or a copy
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
_CHUNK = 4096


def _union(intervals) -> np.ndarray:
    """(m, 2) sorted, non-overlapping union of (start, end) pairs."""
    merged = _profile._merged(sorted(intervals))
    return np.asarray(merged, dtype=float).reshape(-1, 2)


def _busy_before(busy: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Time covered by the merged intervals ``busy`` before each ``t``."""
    if len(busy) == 0:
        return np.zeros_like(t, dtype=float)
    cum = np.concatenate([[0.0], np.cumsum(busy[:, 1] - busy[:, 0])])
    j = np.searchsorted(busy[:, 0], t, side="right") - 1
    inside = np.where(j >= 0,
                      np.minimum(t, busy[np.maximum(j, 0), 1])
                      - busy[np.maximum(j, 0), 0], 0.0)
    return np.where(j >= 0, cum[np.maximum(j, 0)] + inside, 0.0)


def innermost(spans, times) -> list:
    """For each host time in ``times``, the index into ``spans`` ((name,
    start, end) triples) of the innermost span open at it, on any thread:
    of the spans around it, the one that began last (of two that began
    together, the one that ends first); None where no span is open."""
    if not spans:
        return [None] * len(times)
    start = np.array([s for _, s, _ in spans], dtype=float)
    end = np.array([e for _, _, e in spans], dtype=float)
    # rank the spans innermost-last: later start, then earlier end
    order = np.lexsort((-end, start))
    start, end = start[order], end[order]
    out = []
    t_all = np.asarray(times, dtype=float)
    for c in range(0, len(t_all), _CHUNK):
        t = t_all[c:c + _CHUNK, None]
        open_ = (start[None, :] <= t) & (t <= end[None, :])
        last = open_.shape[1] - 1 - np.argmax(open_[:, ::-1], axis=1)
        out += [int(order[i]) if row.any() else None
                for i, row in zip(last, open_)]
    return out


def table(spans, launches: dict, kernels) -> dict:
    """The table by span name (see the module docstring) from plain
    records, times in microseconds: ``spans`` (name, start, end) on the
    host; ``launches`` correlation id -> host time of the runtime call;
    ``kernels`` (correlation id, start, end) on the device.  Seconds
    out."""
    out: dict = {}
    for name, a, b in spans:
        row = out.setdefault(name, {"count": 0, "host_s": 0.0,
                                    "device_s": 0.0, "idle_s": 0.0})
        row["count"] += 1
        row["host_s"] += (b - a) * 1e-6
    out[OUTSIDE] = {"count": 0, "host_s": 0.0, "device_s": 0.0,
                    "idle_s": 0.0}
    times = [launches.get(cid, np.nan) for cid, _, _ in kernels]
    owners = innermost(spans, times)
    for (_, a, b), owner in zip(kernels, owners):
        name = spans[owner][0] if owner is not None else OUTSIDE
        out[name]["device_s"] += (b - a) * 1e-6
    busy = _union((a, b) for _, a, b in kernels)
    for name, row in out.items():
        if name == OUTSIDE:
            continue
        iv = _union((a, b) for n, a, b in spans if n == name)
        covered = (_busy_before(busy, iv[:, 1])
                   - _busy_before(busy, iv[:, 0])).sum()
        row["idle_s"] = float((iv[:, 1] - iv[:, 0]).sum() - covered) * 1e-6
    return out


def records(events):
    """The plain records of :func:`table` from ``torch.profiler``'s
    events: the program's spans, the runtime calls by correlation id, and
    the device's kernels and copies (not the annotations that the
    profiler copies onto the device timeline)."""
    from torch.autograd import DeviceType

    spans, launches, kernels = [], {}, []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append((e.id, e.time_range.start, e.time_range.end))
        elif e.name.startswith(SPAN_PREFIXES):
            spans.append((e.name, e.time_range.start, e.time_range.end))
        elif _RUNTIME.match(e.name):
            launches[e.id] = e.time_range.start
    return spans, launches, kernels


def counters() -> dict:
    """The program's counters now, those it has: ``host_syncs`` (all
    sites) and ``host_syncs.<site>``, ``cg_iterations`` and
    ``bsr_plans.<route>``."""
    from graphlearninglayer_tpu_torch.ops import solve, transductive
    from graphlearninglayer_tpu_torch.utils import profiling

    out = {}
    syncs = getattr(profiling, "host_syncs", None)
    if syncs is not None:
        out["host_syncs"] = sum(syncs.values())
        out.update({f"host_syncs.{k}": v for k, v in syncs.items()})
    iters = getattr(solve.stable_conjgrad, "iterations", None)
    if iters is not None:
        out["cg_iterations"] = iters
    for route, v in getattr(transductive, "bsr_plans", {}).items():
        out[f"bsr_plans.{route}"] = v
    return out


def install() -> None:
    """Wrap ``profile.profile_window`` (once) so that its result carries
    the span table and the counters' changes of the window it traced."""
    original = _profile.profile_window
    if getattr(original, "reads_spans", False):
        return

    def profile_window(*args, **kwargs):
        import torch.profiler

        made = []
        real = torch.profiler.profile

        def keep(*a, **k):
            made.append(real(*a, **k))
            return made[-1]

        before = counters()
        torch.profiler.profile = keep
        try:
            out = original(*args, **kwargs)
        finally:
            torch.profiler.profile = real
        after = counters()
        out["spans"] = table(*records(made[-1].events())) if made else {}
        out["counters"] = {k: v - before.get(k, 0) for k, v in after.items()}
        return out

    profile_window.reads_spans = True
    _profile.profile_window = profile_window


def span_table(ctx) -> dict | None:
    """The traced window's span table, None where the program opened no
    span in it."""
    t = ctx["profile"].get("spans") or {}
    return t if any(n != OUTSIDE for n in t) else None


def counter(ctx, name: str):
    """A counter's change over the traced window, None where the program
    has no such counter."""
    return ctx["profile"].get("counters", {}).get(name)


install()
