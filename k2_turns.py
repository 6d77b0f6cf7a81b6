"""K2 of this checkout against K2 of another commit, on one CUDA card.

    python3 k2_turns.py OTHER_DIR

OTHER_DIR holds the other commit's ``graphlearninglayer_tpu_torch/``, for
example from ``git archive <commit> graphlearninglayer_tpu_torch | tar -x -C
OTHER_DIR`` into a directory that ``.gitignore`` lists.  That package is
loaded beside this one under another name, and each side runs through its
own Python entry points (``ops.kernels.knn_topk.fused_knn(x, k)``,
``ops.transductive_laplace``), so the two may differ in their C entry points
and workspaces.  The other side builds its kernels under OTHER_DIR/build/.

On the clustered features of ``chip_smoke.py``'s ``k2`` phase, at its two
shapes (n=60,250, k=50 and n=1500, k=25), it prints one JSON line a shape:
CUDA-event times of both kernels taken in turns (other, this, this, other),
their ratio, the share of the bound, the largest |dist2| difference between
the two and the rows whose neighbor lists differ.  Then the 60,250-node
solve of ``chip_smoke.py``'s ``solve`` phase runs through each package (one
warm-up, one timed solve) and its accuracy against the cluster labels and
CG iterations are printed; the accuracies must agree within 0.1 point.  The
card's nvidia-smi name and power limit come on a line of their own.  Exits
non-zero when no card is available or a check fails.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

from chip_smoke import (EVAL_BASE, EVAL_K, EVAL_N, EVAL_TAU, NUM_CLASSES,
                        SEED, card_line, check, clustered_features, cuda_ms,
                        k2_bound_ms)

OTHER = "gll_other"
SHAPES = ((EVAL_N, EVAL_K), (1500, 25))
ACC_TOL = 0.1   # points of accuracy between the two solves


def load_other(root: Path):
    """The package at ``root/graphlearninglayer_tpu_torch`` imported as
    ``gll_other`` (its modules import each other relatively)."""
    init = root / "graphlearninglayer_tpu_torch" / "__init__.py"
    if not init.exists():
        raise FileNotFoundError(f"no graphlearninglayer_tpu_torch in {root}")
    spec = importlib.util.spec_from_file_location(
        OTHER, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def turns(x, k, sides, reps):
    """Median ms of each side's ``fused_knn(x, k)``, two runs a side in the
    order other, this, this, other."""
    times = {name: [] for name in sides}
    for name in ("other", "this", "this", "other"):
        fn = sides[name].fused_knn
        times[name].append(cuda_ms(lambda: fn(x, k), reps=reps, warmup=1))
    return times


def solve_acc(ops, x, lab):
    """Accuracy (%) and CG iterations of one timed solve after a warm-up,
    through ``ops.transductive_laplace``, and its seconds."""
    import torch

    y = ops.one_hot_encode(torch.as_tensor(lab[:EVAL_BASE]),
                           NUM_CLASSES).to(x.device)
    cache = ops.EvalGraphCache()
    ops.transductive_laplace(x, y, knn_num=EVAL_K, tau=EVAL_TAU, cache=cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred, iters, err = ops.transductive_laplace(
        x, y, knn_num=EVAL_K, tau=EVAL_TAU, return_info=True, cache=cache)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    acc = 100.0 * (pred.argmax(1).cpu().numpy() == lab[EVAL_BASE:]).mean()
    return float(acc), int(iters), float(err), seconds


def main(argv: list[str]) -> int:
    import torch

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k2_turns.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    from graphlearninglayer_tpu_torch import ops as this_ops
    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as this_k2

    load_other(Path(argv[0]).resolve())
    other_ops = importlib.import_module(f"{OTHER}.ops")
    other_k2 = importlib.import_module(f"{OTHER}.ops.kernels.knn_topk")
    sides = {"other": other_k2, "this": this_k2}
    dev = torch.device("cuda")
    for n, k in SHAPES:
        x = clustered_features(n, SEED + n)[0].to(dev)
        out = {name: side.fused_knn(x, k) for name, side in sides.items()}
        torch.cuda.synchronize()
        times = turns(x, k, sides, reps=5 if n == EVAL_N else 25)
        this_ms = statistics.mean(times["this"])
        other_ms = statistics.mean(times["other"])
        bound_ms, bound_by = k2_bound_ms(n, x.shape[1], k)
        print(json.dumps({
            "phase": "k2_turns", "n": n, "d": x.shape[1], "k": k,
            "order": "other, this, this, other", **times,
            "speedup": other_ms / this_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "this_bound_share": bound_ms / this_ms,
            "other_bound_share": bound_ms / other_ms,
            "max_abs_dist2_diff": (out["this"][1] - out["other"][1])
            .abs().max().item(),
            "rows_nbr_differ": int((out["this"][0] != out["other"][0])
                                   .any(1).sum().item())}), flush=True)
        del out, x
    x, lab = clustered_features(EVAL_N, SEED + 1)
    x = x.to(dev)
    solves = {name: solve_acc(ops, x, lab)
              for name, ops in (("other", other_ops), ("this", this_ops))}
    print(json.dumps({"phase": "k2_turns_solve", "n": EVAL_N, "k": EVAL_K,
                      **{name: dict(zip(("acc", "cg_iters", "cg_err", "s"),
                                        v)) for name, v in solves.items()}}),
          flush=True)
    print(card_line(), flush=True)
    for name, (acc, iters, err, _) in solves.items():
        check(err <= 1e-10, f"the {name} solve converged ({err})")
    check(abs(solves["this"][0] - solves["other"][0]) <= ACC_TOL,
          f"solve accuracy {solves['this'][0]} within {ACC_TOL} point of "
          f"the other K2's {solves['other'][0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
