"""Device tracing hooks.

Twin of ``graphlearninglayer_tpu/utils/profiling.py`` on ``torch.profiler``.
``trace_steps`` wraps a window of training steps in a profile of the host
and, where there is one, the CUDA device, and writes it as a Chrome trace
(viewable in Perfetto or chrome://tracing) into the given directory;
``annotate`` names host-side phases on that timeline.

The drivers turn it on with ``GLL_PROFILE_DIR`` (and ``GLL_PROFILE_EPOCH``,
the epoch to trace, default 1):

    with trace_steps(profile_dir, enabled=epoch == 2):
        for batch in loader: ...
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace_steps", "annotate"]


@contextlib.contextmanager
def trace_steps(trace_dir: str | None, enabled: bool = True):
    """Trace the enclosed steps into ``trace_dir`` (a no-op when it is
    falsy or ``enabled`` is False)."""
    if not trace_dir or not enabled:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir,
                        f"trace_{time.strftime('%Y%m%d-%H%M%S')}_"
                        f"{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def annotate(name: str):
    """Named host-phase annotation on the trace timeline."""
    return record_function(name)
