"""P3 of this checkout against P3 of another commit, on one CUDA card.

    python3 p3_turns.py OTHER_DIR

OTHER_DIR holds the other commit's ``graphlearninglayer_tpu_torch/``, for
example from ``git archive <commit> graphlearninglayer_tpu_torch | tar -x -C
OTHER_DIR`` into a directory that ``.gitignore`` lists.  That package is
loaded beside this one under another name (as ``k2_turns.py`` does), and
each side runs through its own wrapper, ``ops.kernels.ell_spmm.
ell_gather_spmm``, which builds and launches its own ``csrc/ell_spmm.cu``:
this side with the ELL structure's per-row slot counts, the other with
``(nbr, val, x)`` alone when its wrapper takes no counts.

On the graph of ``chip_smoke.py``'s ``ell`` phase (60,250 clustered nodes,
k=50, the symmetric ELL of mode='ell', built once by this package), for
l = 10 and 100 it prints one JSON line an l: both sides' device ms a
matvec by ``chip_smoke.device_ms`` (100 back-to-back launches with the
iterate warm in the L2, and 20 launches each after an L2 flush), taken in
turns (other, this, this, other), their ratio, this checkout's bound and
each side's share of it, and the largest difference between the two
sides' products, which must be within the ``ell`` phase's bar.  The card's
nvidia-smi name and power limit come on a line of their own.  Exits
non-zero when no card is available or a check fails.
"""
from __future__ import annotations

import importlib
import inspect
import json
import statistics
import sys
from pathlib import Path

from chip_smoke import (EVAL_K, EVAL_N, P3_CLASSES, P3_REL_TOL, SEED,
                        card_line, check, clustered_features, device_ms,
                        p3_bound_ms)
from k2_turns import OTHER, load_other


def eval_ell():
    """The ``ell`` phase's graph and its symmetric ELL on the card."""
    from graphlearninglayer_tpu_torch.ops import graph as tg

    x = clustered_features(EVAL_N, SEED + 1)[0].to("cuda")
    g = tg.build_graph(x, EVAL_K, "auto", tiled=True)
    w, _ = tg.edge_weights(g)
    cap = min(tg.ell_cap(int(tg.max_in_degree(g))), 512)
    ovf = int(tg.overflow_count(g, cap))
    return tg.build_sym_ell(g, w, cap, 0 if ovf == 0
                            else -(-ovf // 4096) * 4096)


def main(argv: list[str]) -> int:
    import torch

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("p3_turns.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    from graphlearninglayer_tpu_torch.ops.kernels import ell_spmm as this

    load_other(Path(argv[0]).resolve())
    other = importlib.import_module(f"{OTHER}.ops.kernels.ell_spmm")
    ell = eval_ell()
    other_takes_counts = "counts" in inspect.signature(
        other.ell_gather_spmm).parameters
    calls = {
        "this": lambda xl: this.ell_gather_spmm(ell.nbr, ell.val, xl,
                                                ell.cnt),
        "other": (lambda xl: other.ell_gather_spmm(ell.nbr, ell.val, xl,
                                                   ell.cnt))
        if other_takes_counts
        else (lambda xl: other.ell_gather_spmm(ell.nbr, ell.val, xl)),
    }
    n = ell.nbr.shape[0]
    used = int((ell.val != 0).sum())
    counted = int(ell.cnt.sum())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    diffs = []
    for l in P3_CLASSES:
        xl = torch.randn((n, l), generator=gen, device="cuda")
        out = {name: fn(xl) for name, fn in calls.items()}
        torch.cuda.synchronize()
        diff = (out["this"] - out["other"]).abs().max().item()
        bar = (P3_REL_TOL * ell.val.abs().sum(1).max().item()
               * xl.abs().max().item())
        diffs.append((l, diff, bar))
        times = {f"{name}{kind}": [] for name in calls
                 for kind in ("_ms", "_ms_l2_flushed")}
        for name in ("other", "this", "this", "other"):
            fn = calls[name]
            times[f"{name}_ms"].append(device_ms(lambda: fn(xl)))
            times[f"{name}_ms_l2_flushed"].append(
                device_ms(lambda: fn(xl), reps=20, flush=True))
        this_ms = statistics.mean(times["this_ms"])
        other_ms = statistics.mean(times["other_ms"])
        bound_ms, bound_by = p3_bound_ms(n, n, counted, used, l)
        print(json.dumps({
            "phase": "p3_turns", "l": l, "n": n, "slots": ell.nbr.shape[1],
            "counted_slots": counted, "used_slots": used,
            "other_takes_counts": other_takes_counts,
            "order": "other, this, this, other", **times,
            "speedup": other_ms / this_ms,
            "speedup_l2_flushed":
                statistics.mean(times["other_ms_l2_flushed"])
                / statistics.mean(times["this_ms_l2_flushed"]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "this_bound_share": bound_ms / this_ms,
            "other_bound_share": bound_ms / other_ms,
            "max_abs_diff": diff, "tol": bar}), flush=True)
        del xl, out
    print(card_line(), flush=True)
    for l, diff, bar in diffs:
        check(diff <= bar, f"P3 at l={l}: max |this - other| {diff} <= "
              f"{bar}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
