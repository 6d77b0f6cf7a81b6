"""Device time from the profiler's trace, and CUDA-event kernel timing.

Frozen copies of ``chip_smoke.py``'s ``PROFILE_GROUPS``, ``SOLVE_GROUPS``,
``profile_window`` and ``device_ms``, so that the yardstick does
not move when the smoke script does.  ``profile_window`` here keeps what a
reader needs: each kernel's device time, the groups', the busy time (the
union of kernel intervals) against the host window, and the longest idle
gaps labelled by what the host was doing in them.
"""
from __future__ import annotations

import time

# kernel-name substrings that sort the trace's device time into groups; the
# first group that matches takes the kernel
PROFILE_GROUPS = (
    # K1 (affinity_sym_kernel) and K3 (affinity_tile_kernel)
    ("k1_affinity", ("affinity_sym_kernel", "affinity_tile_kernel")),
    ("conv", ("xmma", "implicit_gemm", "conv", "dgrad", "wgrad", "fft")),
    ("conv_layout", ("nhwctonchw", "nchwtonhwc")),
    ("batchnorm", ("batchnorm", "batch_norm", "bn_")),
    ("cholesky_solve", ("potrf", "trsm", "potrs", "cholesky", "syrk",
                        "cusolver", "magma", "trsv")),
    ("topk_sort", ("topk", "sort", "radix", "bitonic")),
    ("gemm", ("gemm", "cutlass", "sm90_")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise",)),
)
# the transductive solve's groups: K2 first, and its only GEMM is the BSR
# tile product
SOLVE_GROUPS = (
    ("k2_knn", ("knn_",)),
    ("bsr_tile_matmul", ("gemm", "xmma", "cutlass", "sm90_")),
    ("scatter_gather", ("index", "scatter", "gather")),
    ("sort_histogram", ("sort", "radix", "histogram")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "fill")),
)
# the eval runs the encoder and then the solve: the encoder's groups first
EVAL_GROUPS = (("k2_knn", ("knn_",)),) + PROFILE_GROUPS[1:4] + SOLVE_GROUPS[1:]

SPIN_CYCLES = 20_000_000
FLUSH_BYTES = 256 * 2**20
TOP = 10


def _merged(spans):
    """Sorted (start, end) spans merged where they overlap."""
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def group_of(name: str, groups) -> str:
    low = name.lower()
    return next((g for g, keys in groups if any(k in low for k in keys)),
                "other")


def _label_gaps(gaps, host_ops, phase: str):
    """Label each (start, end) gap by the innermost host op running at its
    midpoint ('host_idle' where none runs), prefixed by ``phase``."""
    import numpy as np

    if not host_ops:
        return [f"{phase}:host_idle"] * len(gaps)
    starts = np.array([s for s, _, _ in host_ops])
    ends = np.array([e for _, e, _ in host_ops])
    names = [n for _, _, n in host_ops]
    labels = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if len(inside) == 0:
            labels.append(f"{phase}:host_idle")
        else:
            inner = inside[np.argmax(starts[inside])]
            labels.append(f"{phase}:{names[inner]}")
    return labels


def profile_window(run, steps: int, groups=PROFILE_GROUPS,
                   phase: str = "step") -> dict:
    """torch.profiler over ``steps`` calls of ``run()``, each inside a
    ``record_function(phase)`` range.  Returns the host window and the busy
    time in seconds, device seconds by kernel name and by group, and the
    ``breakdown``: the kernels that took most device time and the longest
    idle gaps by what the host was doing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function(phase):
                run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.events()
    # the device-side copies of the record_function ranges are no work
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name != phase]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    spans = _merged(sorted((e.time_range.start, e.time_range.end)
                           for e in kernels))
    busy_us = sum(b - a for a, b in spans)
    by_group: dict[str, float] = {}
    for name, t in by_name.items():
        g = group_of(name, groups)
        by_group[g] = by_group.get(g, 0.0) + t
    host_ops = [(e.time_range.start, e.time_range.end, e.name) for e in events
                if e.device_type == DeviceType.CPU and e.name != phase
                and not e.name.startswith("ProfilerStep")]
    gaps = sorted(((a[1], b[0]) for a, b in zip(spans, spans[1:])),
                  key=lambda g: g[0] - g[1])[:2000]
    idle: dict[str, float] = {}
    for (a, b), label in zip(gaps, _label_gaps(gaps, host_ops, phase)):
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        window_s=wall_s,
        busy_s=busy_us * 1e-6,
        steps=steps,
        kernel_s={n: t * 1e-6 for n, t in by_name.items()},
        group_s={g: t * 1e-6 for g, t in by_group.items()},
        breakdown={
            "device_ops": [[n[:64], t * 1e-6] for n, t in top_ops],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:TOP]})


def device_ms(fn, reps: int = 100, flush: bool = False) -> float:
    """Device ms of one ``fn()``: CUDA events around ``reps`` back-to-back
    calls, over ``reps``, after warm-up.  The calls are enqueued behind a
    spin kernel, so the device runs them back to back and the host's work
    in each call stays outside the window; that the device had not reached
    the first call when the last was enqueued is checked, with a longer
    spin if not.  With ``flush`` each call has its own events, and a memset
    of FLUSH_BYTES before each evicts the L2."""
    import torch

    for _ in range(3):
        fn()
    scratch = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
               if flush else None)
    cycles = SPIN_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        events = []
        for _ in range(reps if flush else 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if flush:
                scratch.zero_()
            start.record()
            for _ in range(1 if flush else reps):
                fn()
            end.record()
            events.append((start, end))
        ahead = not events[0][0].query()
        torch.cuda.synchronize()
        if ahead:
            return sum(a.elapsed_time(b) for a, b in events) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the host never got ahead of the device")
