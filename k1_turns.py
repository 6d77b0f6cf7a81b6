"""K1 and K3 of this checkout against those of another commit, on one CUDA
card.

    python3 k1_turns.py OTHER_DIR

OTHER_DIR holds the other commit's ``graphlearninglayer_tpu_torch/``, for
example from ``git archive <commit> graphlearninglayer_tpu_torch | tar -x -C
OTHER_DIR`` into a directory that ``.gitignore`` lists.  That package is
loaded beside this one under another name (as ``k2_turns.py`` does), and
each side runs through its own wrappers, ``ops.kernels.affinity.
fused_affinity_sym`` (K1) and ``fused_affinity`` (K3), so each side builds
and launches its own ``csrc/affinity_sym.cu``; the other side builds under
OTHER_DIR/build/.

On the inputs of ``chip_smoke.py``'s ``k1`` and ``k3`` phases at n=1500 and
300, d=128, k=25, it prints one JSON line a kernel and shape: both sides'
device times by ``chip_smoke.device_ms`` (100 back-to-back launches with M
and W warm in the L2, and 20 launches each after an L2 flush), taken in
turns (other, this, this, other), their ratio, the bound and each side's
share of it, and the largest |W| difference between the two designs, which
must be at most 1e-6.  The card's nvidia-smi name and power limit come on a
line of their own.  Exits non-zero when no card is available or a check
fails.
"""
from __future__ import annotations

import importlib
import json
import statistics
import sys
from pathlib import Path

from chip_smoke import (card_line, check, device_ms, k1_bound_ms, k1_inputs,
                        k3_inputs)
from k2_turns import OTHER, load_other

SHAPES = (1500, 300)
W_TOL = 1e-6   # max |W this - W other|
KERNELS = (("k1", "fused_affinity_sym", k1_inputs),
           ("k3", "fused_affinity", k3_inputs))


def turns(sides: dict, entry: str, args: tuple) -> dict:
    """Each side's device ms of ``entry(*args)``, L2 warm and flushed, two
    runs a side in the order other, this, this, other."""
    times = {f"{name}{kind}": [] for name in sides
             for kind in ("_ms", "_ms_l2_flushed")}
    for name in ("other", "this", "this", "other"):
        fn = getattr(sides[name], entry)
        times[f"{name}_ms"].append(device_ms(lambda: fn(*args)))
        times[f"{name}_ms_l2_flushed"].append(
            device_ms(lambda: fn(*args), reps=20, flush=True))
    return times


def main(argv: list[str]) -> int:
    import torch

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_turns.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as this

    load_other(Path(argv[0]).resolve())
    other = importlib.import_module(f"{OTHER}.ops.kernels.affinity")
    sides = {"other": other, "this": this}
    diffs = []
    for label, entry, inputs in KERNELS:
        for n in SHAPES:
            args = inputs(n)
            w = {name: getattr(side, entry)(*args)
                 for name, side in sides.items()}
            torch.cuda.synchronize()
            diff = (w["this"] - w["other"]).abs().max().item()
            diffs.append((label, n, diff))
            times = turns(sides, entry, args)
            this_ms = statistics.mean(times["this_ms"])
            other_ms = statistics.mean(times["other_ms"])
            bound_ms, bound_by = k1_bound_ms(n, args[0].shape[1])
            print(json.dumps({
                "phase": "k1_turns", "kernel": label, "entry": entry, "n": n,
                "d": args[0].shape[1], "order": "other, this, this, other",
                **times, "speedup": other_ms / this_ms,
                "speedup_l2_flushed":
                    statistics.mean(times["other_ms_l2_flushed"])
                    / statistics.mean(times["this_ms_l2_flushed"]),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "this_bound_share": bound_ms / this_ms,
                "other_bound_share": bound_ms / other_ms,
                "max_abs_w_diff": diff, "tol": W_TOL}), flush=True)
            del w, args
    print(card_line(), flush=True)
    for label, n, diff in diffs:
        check(diff <= W_TOL, f"{label} at n={n}: max |W this - W other| "
              f"{diff} <= {W_TOL}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
