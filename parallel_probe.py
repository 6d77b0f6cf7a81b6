#!/usr/bin/env python3
"""The multi-device phases of chip_smoke.py alone, on one CUDA card.

Run from the repository root:  python3 parallel_probe.py

It builds the kernels and runs chip_smoke.py's phase_two_ranks (two ranks
sharing the card over gloo through the driver's CLI, against two
single-device runs), phase_world_of_one (a one-rank NCCL group: the sharded
GL step and the edge- and row-sharded 60,250-node solves) and phase_banded
(the GLL_BANDED_KNN=1 cached solves), with their checks; each prints its
JSON line, then a ``done`` line with the launch counts.  About two minutes
on an H100, a third of the whole smoke.
"""
import sys
import time

import chip_smoke as smoke


def main() -> int:
    import torch

    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2

    if not torch.cuda.is_available():
        print("parallel_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smoke.phase_device()
    smoke.phase_build()
    two = smoke.phase_two_ranks()
    one = smoke.phase_world_of_one()
    # K2's full build at the eval's shape, the banded build's yardstick
    x = smoke.clustered_features(smoke.EVAL_N, smoke.SEED + 1)[0].cuda()
    k2_ms = smoke.cuda_ms(lambda: k2.fused_knn(x, smoke.EVAL_K), reps=5,
                          warmup=1)
    del x
    banded = smoke.phase_banded(k2_ms)
    smoke.emit("done", wall_s=time.perf_counter() - t0, two_ranks=two,
               world_of_one=one, banded=banded, k2_full_ms=k2_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
