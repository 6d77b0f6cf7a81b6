"""Device tracing hooks: the port's spans and its host-sync counter.

Twin of ``graphlearninglayer_tpu/utils/profiling.py`` on ``torch.profiler``.
``trace_steps`` wraps a window of training steps in a profile of the host
and, where there is one, the CUDA device, and writes it as a Chrome trace
(viewable in Perfetto or chrome://tracing) into the given directory.

The drivers turn it on with ``GLL_PROFILE_DIR`` (and ``GLL_PROFILE_EPOCH``,
the epoch to trace, default 1):

    with trace_steps(profile_dir, enabled=epoch == 2):
        for batch in loader: ...

``annotate(name)`` is the port's span.  While a torch profiler records, it
is a record function on the profiler's clock, the timeline of the CUDA
kernels; otherwise it is one shared null context, decided by the
profiler's own flag, so a span costs a flag test when nothing traces.  The
spans, one name a layer (the parent of a span is the one that encloses it,
on any thread):

  * a train step (``train/trainer.py::_gl_update``,
    ``train/adversarial_driver.py::_gl_train_step``): ``gl.encode`` (the
    encoder's forward), ``gl.op.forward`` with ``gl.op.knn``,
    ``gl.op.affinity`` and ``gl.op.solve`` (``ops/laplace.py``,
    ``ops/dense_mode.py``), ``gl.update`` (zeroing the gradients, the
    optimizer and scheduler steps, the step's metrics), and inside it
    ``gl.backward`` (``loss.backward()``), which holds ``gl.op.backward``
    (the op's backward, on autograd's thread);
  * PGD (``attack/pgd.py``): ``pgd.attack``, whose encoder calls and input
    gradients open ``gl.encode`` and ``gl.backward`` (``attack/fgsm.py``);
  * the transductive eval (``evalx/harness.py::test_gl_transductive``):
    ``eval.encode`` and ``eval.solve`` (the bounds of ``stats["encode_s"]``
    and ``stats["solve_s"]``), the solve holding ``eval.knn``,
    ``eval.plan`` and ``eval.cg`` (``ops/transductive.py``), and every
    CG iteration's residual check ``eval.cg.check`` (``ops/solve.py``).

The span is not ``torch.profiler.record_function``: that opens a user
range, and the profiler copies each user range onto the device timeline as
an annotation that spans the kernels launched inside it, which a reader of
the trace's device events would take for device work.

``host_syncs`` counts, by site, every point on the train and eval paths
where the host waits for the device: a read of a device result, a device
synchronize, a blocking copy of a host array to the device.  Each such
site calls :func:`host_sync` as it waits.  The count is always on and
counts on the CPU too, where nothing waits: it counts the sites a run
passes.  Other counters of the same kind: ``ops.solve.stable_conjgrad.
iterations`` (every CG iteration), ``ops.transductive.bsr_plans`` (BSR
plans by route), ``models.buildnet.encoder_layouts`` (the encoder's CUDA
inputs, by whether they arrived NHWC-strided or were restrided) and the
kernels' ``launches``.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace_steps", "annotate", "host_sync", "host_syncs"]

_NO_SPAN = contextlib.nullcontext()

# site -> waits counted since the process started
host_syncs: dict[str, int] = {}


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
    """The span ``name`` on the trace timeline while a profiler records;
    the shared null context otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def host_sync(site: str) -> None:
    """Count one wait of the host for the device at ``site``."""
    host_syncs[site] = host_syncs.get(site, 0) + 1
