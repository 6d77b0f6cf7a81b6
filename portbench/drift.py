"""How far the eval's graph moves between two evals: the port's own
FullySup driver against the eval cell's traffic.

    python -m portbench.drift --workload c10_r18_gl.eval60k
        --sigmas 0.003 0.01 0.03 --driver-epochs 16 --driver-epochs-sparse 45

First the driver (`train/fullysup.py --sup_train_type gl --device_data`,
its defaults otherwise, on its synthetic stand-in at CIFAR-10's geometry:
50,000 + 10,000 images) trains and evaluates, once with an eval every
epoch and once every ``--every`` epochs (its default, 15).  Then the
cell's session runs a few evals at each drift of ``--sigmas``.  For each
eval after the first, one JSON line: the share of the train and test
nodes' neighbours (K2's lists, base rows mapped to the train rows they
are) that changed since the eval before (and, for the driver's every-epoch
run, since its first eval), the fresh BSR plans it made (k-means, where
the cache's permutation was stale or absent) and its CG iterations.  It
needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from .common import check
from .run import REPO, resolve


def canonical(nbr: torch.Tensor, base_rows, k_lab: int) -> torch.Tensor:
    """The lists of the train and test nodes, with each base node (the
    first ``k_lab``) named as the train node it copies, sorted by index."""
    base = torch.as_tensor(base_rows, device=nbr.device).long() + k_lab
    nbr = nbr[k_lab:].long()
    nbr = torch.where(nbr < k_lab, base[nbr.clamp(max=k_lab - 1)], nbr)
    return torch.sort(nbr, dim=1).values.int()


def replaced(a: torch.Tensor, b: torch.Tensor, block: int = 4096) -> float:
    """The share of the entries of lists ``a`` not in the same row of
    ``b``."""
    miss = 0
    for s in range(0, len(a), block):
        x, y = a[s:s + block], b[s:s + block]
        miss += int((~(x[:, :, None] == y[:, None, :]).any(-1)).sum())
    return miss / a.numel()


class Watch:
    """Taps on the eval's K2 lists and fresh BSR plans."""

    def __init__(self):
        from graphlearninglayer_tpu_torch.ops import graph, transductive

        self.knn = check.Tap(graph, "knn_tiled")
        self.plan = check.Tap(transductive, "bsr_plan")
        self.lists: list = []
        self.plans = 0

    def record(self, base_rows, k_lab: int, **extra) -> dict:
        cur = canonical(self.knn.out[0], base_rows, k_lab)
        line = {"eval": len(self.lists) + 1,
                "fresh_plans": self.plan.calls - self.plans, **extra}
        if self.lists:
            line["replaced_since_last"] = replaced(cur, self.lists[-1])
            line["replaced_since_first"] = replaced(cur, self.lists[0])
        self.plans = self.plan.calls
        self.lists.append(cur)
        return line

    def close(self):
        self.knn.close()
        self.plan.close()


def driver(epochs: int, every: int, cfg: dict, extra=()):
    """The FullySup driver's evals over ``epochs`` epochs, an eval every
    ``every`` epochs (``extra``: further driver arguments)."""
    from graphlearninglayer_tpu_torch.config.cli import parse_option
    from graphlearninglayer_tpu_torch.train import fullysup

    opt = parse_option([
        "--sup_train_type", "gl", "--device_data", "--cosine",
        "--dataset", "cifar10", "--data_folder", "build/no_such_data",
        "--synth_n_train", str(cfg["train_images"]),
        "--synth_n_test", str(cfg["test_images"]),
        "--epochs", str(epochs), "--plot_freq_ss", str(every),
        "--epsilon", str(cfg["epsilon"]), "--viz_max_n", "0",
        "--num_workers", "0", *extra])
    watch = Watch()
    evaluate = fullysup.test_gl_transductive
    k_lab = cfg["base_per_class"] * cfg["num_classes"]
    lines = []

    def tapped(*args, **kw):
        acc = evaluate(*args, **kw)
        lines.append(watch.record(kw["resident"][2], k_lab,
                                  cg_iters=kw["stats"]["cg_iters"],
                                  acc=acc))
        return acc

    fullysup.test_gl_transductive = tapped
    try:
        fullysup.run_training(opt)
    finally:
        fullysup.test_gl_transductive = evaluate
        watch.close()
    return lines


def cell(workload: str, sigma: float, evals: int, seed: int):
    """The cell's session at drift ``sigma``: ``evals`` evals."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    r = resolve(bench, workload, REPO,
                {"traffic": {"drift_sigma": sigma}})
    s = r["session"].Session(r["cfg"], r["traffic"], r["encoder"], seed,
                             "cuda")
    s.build()
    watch = Watch()
    lines = []
    try:
        for _ in range(evals):
            s.eval_once()
            lines.append(watch.record(s.last_base, s.n_nodes()
                                      - len(s.train_u8) - len(s.test_u8),
                                      cg_iters=s.stats[-1]["cg_iters"]))
    finally:
        watch.close()
        s.release()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.drift")
    ap.add_argument("--workload", default="c10_r18_gl.eval60k")
    ap.add_argument("--sigmas", type=float, nargs="*", default=[])
    ap.add_argument("--evals", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--driver-epochs", type=int, default=0)
    ap.add_argument("--driver-epochs-sparse", type=int, default=0)
    ap.add_argument("--every", type=int, default=15)
    args = ap.parse_args(argv)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = resolve(bench, args.workload)["cfg"]
    runs = [("driver_every_1", lambda: driver(args.driver_epochs, 1, cfg))
            ] if args.driver_epochs else []
    if args.driver_epochs_sparse:
        runs.append((f"driver_every_{args.every}",
                     lambda: driver(args.driver_epochs_sparse, args.every,
                                    cfg)))
    runs += [(f"cell_sigma_{s}", lambda s=s: cell(args.workload, s,
                                                   args.evals, args.seed))
             for s in args.sigmas]
    for name, fn in runs:
        for line in fn():
            print(json.dumps({"run": name, **line}), file=sys.__stdout__,
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
