"""The readings that the limits of `correct` are set from.

    python -m portbench.control --workload <name> --program-seeds 1 2 ...
                                --variant-seeds 7 8 9

For each program seed: the cell's set-up and the program's compared steps
or eval at the cell's own size, then the same comparison as a run makes
(the lower readings).  For each variant seed: each of the session's
variants put in the program's place (the control, the reference in the
precision below the configuration's, and the planted faults) and compared
the same way (the upper readings).  One JSON line a reading, then a summary
line: each number's largest program reading and each variant's smallest.
It needs a CUDA device; the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

from .run import REPO, resolve


def readings(workload: str, program_seeds, variant_seeds,
             device: str = "cuda", overrides=None):
    import torch

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    r = resolve(bench, workload, REPO, overrides)

    def session(seed):
        return r["session"].Session(r["cfg"], r["traffic"], r["encoder"], seed,
                                    device)

    def free():
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    for seed in program_seeds:
        s = session(seed)
        s.start_checked()
        subject = s.subject()
        s.release()
        free()
        look = s.diagnose(subject) if hasattr(s, "diagnose") else {}
        yield {"subject": "program", "seed": seed, **s.judge(subject),
               "look": look}
        del s, subject
        free()
    for seed in variant_seeds:
        s = session(seed)
        for name, make in s.variants().items():
            yield {"subject": name, "seed": seed, **s.judge(make())}
            free()
        del s
        free()


def summary(lines) -> dict:
    out: dict = {}
    for line in lines:
        who = line["subject"]
        for k, v in line.items():
            if k in ("subject", "seed", "look"):
                continue
            agg = out.setdefault(who, {})
            pick = max if who == "program" else min
            agg[k] = v if k not in agg else pick(agg[k], v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--variant-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    lines = []
    for line in readings(args.workload, args.program_seeds,
                         args.variant_seeds):
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload,
                      "summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
