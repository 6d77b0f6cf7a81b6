"""P1 and P2 of this checkout against P1 and P2 of another commit, on one
CUDA card.

    python3 probes_turns.py OTHER_DIR

OTHER_DIR holds the other commit's ``graphlearninglayer_tpu_torch/``, for
example from ``git archive <commit> graphlearninglayer_tpu_torch | tar -x -C
OTHER_DIR`` into a directory that ``.gitignore`` lists.  That package is
loaded beside this one under another name (as ``k2_turns.py`` does), and
each side runs through its own wrappers, ``ops.kernels.row_sort.row_sort``
and ``scale_if_max_positive`` and ``ops.kernels.take_along.take_along``,
which build and launch its own ``csrc/row_sort.cu`` and
``csrc/take_along.cu``.

On the inputs of ``chip_smoke.py``'s ``probes`` phase (P1's sort at 256 x
512 and 64 x 1,024 in both directions, its gated scale at 256 x 512 and
at 1,000,003 elements, each with a positive max and without, P2 at the
probe's six cases) it prints one JSON
line a case: both sides' device ms by ``chip_smoke.device_ms`` (100
back-to-back launches, L2 warm), taken in turns (other, this, this,
other), their ratio, the plain version's and the library call's ms (once
each), the bound, and the launch floor (a kernel that returns at once).
Both sides' outputs must be equal bit for bit, and equal to the plain
version's.  The card's nvidia-smi name and power limit come on a line of
their own.  Exits non-zero when no card is available or a check fails.
"""
from __future__ import annotations

import importlib
import json
import statistics
import sys
from pathlib import Path

from chip_smoke import (card_line, check, device_ms, launch_floor_ms,
                        p1_p2_bound_ms, probe_inputs)
from k2_turns import OTHER, load_other


def same_bits(a, b) -> bool:
    """Equal shapes and dtypes and equal bits (NaN equal to its own bits)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def turns(calls: dict) -> dict:
    """Device ms of each side's call, two runs a side in the order other,
    this, this, other."""
    times = {f"{name}_ms": [] for name in calls}
    for name in ("other", "this", "this", "other"):
        times[f"{name}_ms"].append(device_ms(calls[name]))
    return times


def main(argv: list[str]) -> int:
    import torch

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probes_turns.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    from graphlearninglayer_tpu_torch.ops.kernels import row_sort as this_p1
    from graphlearninglayer_tpu_torch.ops.kernels import take_along as this_p2

    load_other(Path(argv[0]).resolve())
    sides = {
        "other": (importlib.import_module(f"{OTHER}.ops.kernels.row_sort"),
                  importlib.import_module(f"{OTHER}.ops.kernels.take_along")),
        "this": (this_p1, this_p2)}
    blocks, signs, gathers = probe_inputs()
    floor_ms = launch_floor_ms()
    cases = []      # (name, outputs of each side, plain's outputs)

    def run_case(name: str, calls: dict, plain, library, nbytes: int,
                 **fields) -> None:
        out = {side: fn() for side, fn in calls.items()}
        want = plain()
        torch.cuda.synchronize()
        times = turns(calls)
        this_ms = statistics.mean(times["this_ms"])
        other_ms = statistics.mean(times["other_ms"])
        bound_ms = p1_p2_bound_ms(nbytes)
        print(json.dumps({
            "phase": "probes_turns", "case": name, **fields,
            "order": "other, this, this, other", **times,
            "speedup": other_ms / this_ms,
            "plain_ms": device_ms(plain),
            "library_ms": device_ms(library) if library else None,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "this_bound_share": bound_ms / this_ms,
            "other_bound_share": bound_ms / other_ms,
            "launch_floor_ms": floor_ms}), flush=True)
        cases.append((name, out, want))

    for (q, m), x in blocks.items():
        for desc in (False, True):
            run_case(
                f"row_sort_{q}x{m}{'_desc' if desc else ''}",
                {side: (lambda p1=mods[0], x=x, desc=desc:
                        p1.row_sort(x, desc))
                 for side, mods in sides.items()},
                lambda x=x, desc=desc: this_p1.row_sort_plain(x, desc),
                lambda x=x, m=m, desc=desc: torch.topk(x, m, dim=1,
                                                       largest=not desc),
                16 * q * m, q=q, m=m, descending=desc)
    for sign, x in signs.items():
        run_case(
            f"scale_if_max_positive_{sign}",
            {side: (lambda p1=mods[0], x=x: p1.scale_if_max_positive(x))
             for side, mods in sides.items()},
            lambda x=x: this_p1.scale_if_max_positive_plain(x), None,
            8 * x.numel(), numel=x.numel())
    for (m, n, axis), (x, idx) in gathers.items():
        run_case(
            f"take_along_{m}x{n}_axis{axis}",
            {side: (lambda p2=mods[1], x=x, idx=idx, axis=axis:
                    p2.take_along(x, idx, axis))
             for side, mods in sides.items()},
            lambda x=x, idx=idx, axis=axis:
                this_p2.take_along_plain(x, idx, axis),
            lambda x=x, idx=idx, axis=axis:
                torch.take_along_dim(x, idx, axis),
            16 * m * n, m=m, n=n, axis=axis)
    print(card_line(), flush=True)
    for name, out, want in cases:
        pair = [o if isinstance(o, tuple) else (o,)
                for o in (out["this"], out["other"], want)]
        check(all(same_bits(a, b) for a, b in zip(pair[0], pair[1])),
              f"{name}: this side's output equals the other side's")
        check(all(same_bits(a, b) for a, b in zip(pair[0], pair[2])),
              f"{name}: this side's output equals the plain version's")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
