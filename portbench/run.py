"""One run of one benchmark cell of graphlearninglayer_tpu_torch.

    python -m portbench --workload <name> --seed <n> --seconds <s>
                        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Everything is found by the names in ``BENCHMARK.json``:

* the configuration: its ``file`` (``configs/<config>.json``, the sizes as
  run), and the encoder that it names (``encoders/<model>.py``: the
  program's model, the reference's features and the work an image);
* the traffic: ``traffic/<traffic>.json``, whose ``session`` names the
  general runner in ``sessions/`` that runs it;
* the limits of the comparison that decides ``correct``:
  ``limits/<workload>.json``;
* each per-layer metric: its reader, ``metrics/<metric>.py``.

A run makes its inputs and weights from the seed on the device, builds the
program and drives it through the steps the comparison reads, warms up,
then either measures the end-to-end metrics for ``--seconds`` (``--trace
0``) or profiles a short window and reads the per-layer metrics
(``--trace 1``).  Then it frees the program, runs the reference, and prints
each compared number beside its limit on stderr and, as its last line on
stdout, one JSON object.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "graphlearninglayer_tpu")
_T0 = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time; the
    module's import time where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(bench: dict, workload: str, root: Path = REPO,
            overrides: dict | None = None) -> dict:
    """Everything a cell's run needs, found by its names."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{', '.join(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg_path = root / entry["file"]
    cfg = json.loads(cfg_path.read_text())
    bench_dir = cfg_path.parent.parent
    traffic = json.loads((bench_dir / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits"
                         / f"{workload}.json").read_text())["limits"]
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    pkg = __package__ or "portbench"
    encoder = importlib.import_module(f"{pkg}.encoders.{cfg['model']}")
    session = importlib.import_module(f"{pkg}.sessions.{traffic['session']}")

    def applies(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m) and m["moves"] in moves]
    readers = {m["name"]: load_file(bench_dir / "metrics"
                                    / f"{m['name']}.py",
                                    "portbench_metric_"
                                    + m["name"].replace(".", "_"))
               for m in per_layer}
    return dict(cell=cell, cfg=cfg, traffic=traffic, limits=limits,
                encoder=encoder, session=session, e2e=e2e, per_layer=per_layer,
                readers=readers)


def check_precision(cfg: dict) -> None:
    """The program runs as the configuration states: float32 matrix
    products in full float32 and cuDNN's convolutions in TF32, PyTorch's
    defaults.  A caller that changed them is refused."""
    import torch

    want = cfg["precision"]
    conv_tf32 = want["convolutions"] == "tf32"
    mm_tf32 = want["matmul"] == "tf32"
    if (torch.backends.cudnn.allow_tf32 != conv_tf32
            or torch.backends.cuda.matmul.allow_tf32 != mm_tf32):
        raise RuntimeError("the TF32 settings differ from the "
                           "configuration's precision")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench_path: Path | None = None,
             overrides: dict | None = None,
             setup_clock=process_age_s) -> dict:
    """One run of ``workload``; returns the result object.  The tests call
    it on the CPU at a tiny size through ``overrides``."""
    import torch

    bench_path = bench_path or REPO / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    r = resolve(bench, workload, bench_path.parent, overrides)
    cuda = torch.device(device).type == "cuda"
    check_precision(r["cfg"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sess = r["session"].Session(r["cfg"], r["traffic"], r["encoder"], seed,
                                device)
    sess.start()
    setup_s = setup_clock()
    metrics, extra = {}, {}
    if trace:
        ctx = sess.trace()
        tally = sess.tally()
        for m in r["per_layer"]:
            value = r["readers"][m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        prof = ctx["profile"]
        extra = {"busy_s": prof["busy_s"], "window_s": prof["window_s"]}
        breakdown = prof["breakdown"]
    else:
        window = sess.window(seconds)
        tally = sess.tally()
        window["setup_s"] = setup_s
        for m in r["e2e"]:
            metrics[m["name"]] = {"value": window[m["name"]],
                                  "unit": m["unit"]}
        breakdown = None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if hasattr(sess, "context"):
        print(f"context {sess.context()}", file=sys.stderr)
    subject = sess.subject()
    sess.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from .common.check import verdict

    ok, shown = verdict(sess.judge(subject), r["limits"])
    result = {
        "correct": ok,
        "attempted": tally[0],
        "failed": tally[1],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": r["cell"]["chips"],
                   "memory_peak_bytes": peak, **extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = shown
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    chips = {c["name"]: c["chips"] for c in bench["workloads"]}
    if args.workload not in chips:
        print(f"portbench: unknown workload {args.workload!r}",
              file=sys.stderr)
        return 2
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips[args.workload]:
        print(f"portbench: {args.workload} needs {chips[args.workload]} "
              f"CUDA device(s); found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in result["checked"].items():
        print(f"checked {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
