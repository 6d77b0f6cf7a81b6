#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

It drives the port's two main paths at the flagship's full width.  Training:
FullySup GL training (ResNet-18 encoder, mlp head, 128-d features, graph
Laplace learning in dense mode, custom CE, SGD with momentum and a cosine
schedule), 250 base + 1250 batch 32x32x3 uint8 images per step, 10 classes,
k=25, tau=0.07, eps='auto'.  Eval: the transductive eval over 250 base +
50,000 train + 10,000 test images (60,250 nodes), k=50, tau=1e-8, eps='auto',
a CG solve in bsr mode.  Weights are random, drawn from a seeded generator;
the images come from the port's synthetic dataset.  Phases, one JSON line
each:

  device  the card, its power limit, torch and CUDA versions;
  build   every CUDA kernel of the port, compiled from csrc/ with one nvcc
          per source, all started together;
  k1      kernel K1 against its plain PyTorch version on the card at the
          op's shape (n=1500, d=128, k=25) and at n=300, max |diff| <= 1e-6,
          W exactly symmetric; on a batch at n=1500 with 30 rows copied
          onto others (k1_dup), W exactly 0 on every copied pair in both
          (each kept entry's d2 from the rows' difference) and within 1e-6
          elsewhere; its device time over a run of 100
          back-to-back launches (M and W, 18 MB at n=1500, stay in the
          50 MB L2 between them), over 20 launches with L2 flushed before
          each, and one call's time with the wrapper's host work in it
          (call_ms), beside the reckoned bound and its share;
  k2      kernel K2 (fused KNN) against its plain version at the eval's
          shape (n=60,250, d=128, k=50) and at n=1500, k=25, on clustered
          features: max |dist2 diff| <= 1e-5; the same neighbor sets on
          every row outside the boundary-tie set (k-th and (k+1)-th plain
          distances within twice that measured error), and on each row
          that differs exactly one neighbor swapped at the boundary, on at
          most 0.1% of rows; CUDA-event times of the kernel, the plain
          route and one cdist + topk, its achieved TFLOP/s and share of
          the bound; then (k2_rows) K2 over each half of the rows, a
          rank's share of a two-rank sharded build: bit for bit the full
          call's rows, against the plain version's range with the same
          bar, timed beside the half's one-triangle bound; and (k2_dup) a
          batch at n=1500 with 30 rows copied onto others: each copy in
          its row's second slot at d2 exactly 0, in the kernel and the
          plain version, and d2 within 1e-6 of the plain version's on the
          rows whose lists are equal;
  op      laplace_learning forward + backward on the card in float32 against
          the port's float64 CPU result on the same input;
  entry   the flagship forward through entry() (graphlearninglayer_tpu_torch/
          entry.py, the twin of __graft_entry__.py): ResNet-18 and the
          dense op at 250 + 1250 nodes, float32 with TF32 off; its ms
          (CUDA events, median of 10), K1 once a forward, the KNN sets
          against the same forward on the CPU in float64 outside the
          float32 tie band, and the scores against the CPU's float64 op on
          the card's graph within 3e-4 (the CPU float32 op's error there
          printed beside it);
  train   20 full-width train steps in float32 (TF32 off everywhere), 20
          with float32 parameters and TF32 convolutions (cuDNN's default),
          then 5 in bf16 (encoder under autocast, TF32 off), and one eval
          step on held-out images: the main path, across which K1's launch
          count is read; then (knn_select) the exact KNN's selection by
          (d2, index) and its two routes (a stable sort, a repaired
          top-k) against a bare torch.topk, device ms at the step's
          1,500 x 1,500, at 2,048 x 8,192 and at a 2,048 x 60,250 panel;
  profile torch.profiler over 3 more warm float32 steps (TF32 off): device
          time by kernel and the device's busy share, and K1's in-step
          device time per launch (its group must read above zero);
  parity  one train step at a reduced batch (40 + 160) from identical
          weights on the card and on the CPU, TF32 off;
  solve   transductive_laplace at 60,250 nodes on clustered features with
          an EvalGraphCache: two warm-up and three timed solves, the mode
          that ran, CG iterations and residual, peak memory, and a profile
          of one more solve;
  solve_parity  the same solve at 10,250 nodes on the card (float32)
          against the port on the CPU (float64);
  ell     kernel P3 (ops/kernels/ell_spmm.py, the ELL gather SpMM) on the
          solve's graph (60,250 nodes, k=50) in the symmetric ELL form of
          mode='ell': its slots S, the slots each row counts, padding and
          overflow; for l = 10 and 100 the kernel (over each row's
          counted slots) against its plain version (1e-6 max_i
          sum_s |val[i, s]| max |x| an entry), its device ms per matvec
          (100 launches, L2 warm; 20 flushed) beside the plain version's,
          a torch.sparse CSR product's (of the slots in use) and
          bsr_spmm's on the same graph, the bound (val and nbr on the
          counted slots, the counts, x and out once) beside the previous
          design's count (val on every slot, nbr on the used ones), and
          the bytes of 32-byte L2 sectors that the used slots' rows of x
          span (a floor for a design that gathers each from L2, not the
          bound); then (ell_solve) transductive_laplace(mode='ell'),
          two warm-up and three timed solves: converged, >= 99.9% equal
          argmax against mode='bsr', P3 exactly CG iterations + 2 times a
          solve;
  transductive_eval  the eval main path: test_gl_transductive with the
          trained float32 state over 250 + 50,000 + 10,000 synthetic
          images, across which K2's launch count is read;
  k3      kernel K3 (affinity times a precomputed mask) against its plain
          version at n=1500, d=128 with the KNN mask (k=25, no self loops)
          of the port's knn, at n=300, and with a fixed eps: max |diff|
          <= 1e-6, device times as in k1 and the reckoned bound (no path
          calls K3);
  probes  kernels P1 (a bitonic row sort, ascending and descending, and a
          scale gated on the array's max, also above its one-cluster
          limit) and P2 (take_along_axis) at the shapes of the TPU probes
          they replace, which no path calls: each
          case once with its count read, then equal to its plain version
          (torch.sort(stable=True), torch.gather), its device ms beside
          the plain version's, torch.topk's / torch.take_along_dim's and
          the bound;
  op_edge laplace_learning in edge mode with the Cholesky and then the CG
          solver, forward + backward on the card at the op's shape, against
          the port's float64 CPU result and against dense mode on the card,
          with the CG iterations;
  fullysup  the driver through its CLI entry point, main(argv), in a
          temporary directory: ResNet-18 GL training at full width for 2
          epochs of 40 steps over the synthetic stand-in for CIFAR-10 (50,000
          + 10,000 images at 32x32x3), with native augmentation, a traced
          second epoch and three transductive evals of 60,250 nodes through
          one cache, across which K1's and K2's launch counts are read; then
          three 1-epoch runs at 5,000 + 1,000 images: a resume from the main
          run's last checkpoint, the MLP branch, and --gl_solver cg;
  adversarial  the adversarial path, the reference's cifar10 config at full
          width through the drivers' entry points: PGD-robust training of
          the GL and MLP heads (PreActResNet-18, feat_dim 128, batch 200,
          10 base images a class, 5 PGD iterations at eps 0.05, alpha
          0.01; tau 0, k 25; SGD, cosine) for 1 epoch over a 4,000 + 400
          image synthetic CIFAR-geometry stand-in, and a natural GL run;
          the driver's own step (``make_train_step``) timed step by step
          after a warm-up, robust and natural GL and robust MLP, and three
          robust GL steps under the profiler (K1 launched exactly 6 times
          a step); the IFGSM sweep [0, 0.05, 0.1] and CW at c=10
          (cw_iters cut from 100 to 20) on the trained checkpoint, 500
          base + 200 batch = 700 nodes an op call; then the mnist config:
          SmallCNNGL natural training (1 epoch, 12,000 + 1,000 images,
          1,100 nodes, dense) and one FGSM point at 10,000 base + 1,000
          batch = 11,000 nodes (edge mode, Cholesky); K1's device ms at
          n = 300, 700 and 1,100 beside its bound.  Every Cholesky (tau 0)
          of the path must succeed, the 11,000-node point's included, every
          loss and accuracy be finite, and the PGD outputs stay in the eps
          ball and the data range;
  device_aug  the augmentation on the card (data/device_aug.py): every
          RandAugment op at four magnitudes and both signs, the prefix warp
          and the cutout at fixed parameters on a 32x32x3 and a 28x28x1
          image, the card's uint8 output against the port's on the CPU and
          the native backend's (a differing pixel is reported with its
          source coordinate's distance to the integer boundary, and fails
          unless that is <= 1e-9); the cifar10 weak and strong and mnist
          strong transforms over 1,500 images, the card against the CPU at
          the same draws on 64 of them; ms to augment 1,500 32x32x3 images
          in strong mode on the card beside the native backend's on the
          host's cores;
  device_data  the fullysup run with --device_data (the splits resident
          on the card, the augmentation there): K1 once a GL step, K2 once
          in each of the three resident 60,250-node evals, each converged
          above chance; ms a step beside the fullysup phase's and the bare
          step's, the traced epoch's busy share and host-to-device bytes a
          step (at most 64 KB: index and label vectors); the resident
          encode of the run's last state equal to the streaming encode bit
          for bit over 5,000 images;
  visualize  the visualize CLI on that run's last checkpoint: it restores
          and encodes 2,000 train and 1,024 test images; the plots and the
          probe run or print "skipped";
  compare  compare_to_mlp at the CLI defaults (ResNet-18, 250 + 1250,
          k=25, tau 0.07) for 2 epochs of 12 steps on the synthetic
          CIFAR-geometry set: K1 once a step, finite losses; one step's GL
          loss equal to the model's before that step's update;
  supcon  SupCon and SimCLR, each on the host path and with --device_data
          (ResNet-18, 1250 images x 2 views, 2 epochs of 4 steps): finite
          losses, each checkpoint restored, ms a step;
  parallel_two_ranks  two ranks sharing the card over gloo, started with a
          launcher's variables, run the driver's CLI (the fullysup flags,
          1 epoch of 8 steps on 10,000 train images, 50,000 test images so
          that both evals have 60,250 nodes, TF32 off, random base
          refresh): per-step losses within 1e-3 of the single-device run's,
          the epoch-0 eval within 0.5 points, both evals edge-sharded and
          converged; K1 once a step on each rank, K2 once a rank an eval
          over its half of the rows; a second single-device run under
          cuDNN's deterministic algorithms reports the run's own spread;
  parallel_train  a process group of one rank over NCCL: 10 sharded
          ResNet-18 GL steps (250 + 1250, TF32 convolutions), each from the
          single-device step's state: losses within 1e-5 relative, K1 once
          a step, ms a step each way;
  parallel_solve  in that group, the edge- and the row-sharded solves at
          60,250 nodes (k=50, tau 1e-8) against the single-device solve:
          residual <= 1e-10, >= 99.9% equal argmax, K2 once a build, s a
          solve, P3 CG iterations + 2 times a row-sharded solve;
  dryrun  dryrun_multichip(2), two spawned ranks sharing the card over
          gloo, and dryrun_multichip(1), a world of one over NCCL: the
          driver on the mesh twice (edge-sharded evals, then
          --device_data), the row- and edge-sharded solves within 1e-4 of
          each other, one sharded FGSM; each run's seconds, its ranks'
          parts, no "exploding gradient" in the ranks' output, and on
          every rank K1 6 times in the driver and twice in the FGSM, K2 4
          times in the driver and twice in the solves, P3 the row-sharded
          solve's CG iterations + 2 times; before each run K1
          and K2 against their plain versions at the shapes it gives them
          (K2 on every rank's row range);
  sharded_attack  make_sharded_gl_fast_gradient_attack at the cifar10
          attack's shape (PreActResNet-18 with random weights, 500 base +
          200 batch = 700 nodes, tau 0, k 25), an FGSM and an IFGSM point
          at eps 0.05, beside the single-device attack (TF32 off, cuDNN
          and PyTorch deterministic): a world of one over NCCL gives its
          images and predictions exactly; two ranks over gloo the first
          step's input gradient within 1e-4 of its largest entry and >= 99%
          equal predictions; K1 iters + 1 times a point on every rank;
          seconds a point each way;
  banded  GLL_BANDED_KNN=1: three cached 60,250-node solves on drifted
          features through the banded KNN and through K2, the banded
          build's ms beside K2's and its fallback fraction;

then the ``kernels`` line, the card's name and power limit as nvidia-smi
prints them, and the final ``{"ok": true, ...}`` line.  Any failed check
raises, and the script exits non-zero without the final line.
"""
from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import time

SEED = 0
N_BASE, N_BATCH, NUM_CLASSES, K, TAU = 250, 1250, 10, 25, 0.07
F32_STEPS, TF32_STEPS, BF16_STEPS = 20, 20, 5
K1_TOL = 1e-6
# the transductive eval: base + train + test nodes, neighbors and tau
EVAL_BASE, EVAL_TRAIN, EVAL_TEST = 250, 50_000, 10_000
EVAL_K, EVAL_TAU = 50, 1e-8
EVAL_N = EVAL_BASE + EVAL_TRAIN + EVAL_TEST
PARITY_N = 10_250
K2_TOL = 1e-5            # max |dist2 kernel - plain|
K2_MAX_DIFFER = 1e-3     # share of rows whose neighbor sets may differ
K3_TOL = 1e-6
# the driver run: synthetic CIFAR-10 geometry, full width, 2 epochs
DRIVER_TRAIN, DRIVER_TEST, DRIVER_EPOCHS = 50_000, 10_000, 2
DRIVER_ARGV = [
    "--sup_train_type", "gl", "--dataset", "cifar10", "--model", "resnet18",
    "--head_type", "mlp", "--batch_size", str(N_BATCH),
    "--num_train", str(N_BASE), "--knn_k", str(K), "--epsilon", "auto",
    "--temp", str(TAU), "--tau", str(EVAL_TAU), "--cosine",
    "--augment_type_sup", "strong", "--plot_freq_ss", "1"]
# the adversarial path: the reference's cifar10 config with only the data
# cut (train / test images), CW's iterations cut from 100, and the mnist
# config at enough images for its FGSM base set (1,000 a class)
ADV_TRAIN, ADV_TEST, ADV_CW_ITERS = 4000, 400, 20
ADV_SWEEP, ADV_C = [0.0, 0.05, 0.1], [10.0]
ADV_MNIST_TRAIN, ADV_MNIST_TEST = 12_000, 1000
ADV_TIMED_STEPS, ADV_PROFILE_STEPS = 10, 3
# the device-resident path: one step's base + batch images augmented on the
# card, the fixed-parameter parity grid, and the host-to-device bytes a
# step may copy once the splits are on the card (index and label vectors:
# 2 x 1250 int64 = 20 KB; the host pipeline copies 4.6 MB of images)
AUG_BATCH, AUG_PARITY_ROWS = N_BASE + N_BATCH, 64
DD_MAX_H2D_BYTES_PER_STEP = 64 * 1024
DD_CHECK_ROWS = 5000        # random images for resident vs streaming encode
# the compare and SupCon drivers at the CLI defaults, cut in data: 12 and 4
# steps an epoch, 2 epochs (the second one's ms a step is reported)
COMPARE_TRAIN, SUPCON_TRAIN, SHORT_EPOCHS = 15_000, 5000, 2
VIZ_POINTS = 2000
# the multi-device path on one card: 10 sharded steps in a world of one
# over NCCL, and two ranks sharing the card over gloo running the driver
# for one epoch of 8 steps (10,000 train images) with 50,000 test images,
# so that its evals have 60,250 nodes
PAR_STEPS = 10
PAR_TRAIN = 8 * N_BATCH
PAR_TEST = EVAL_N - N_BASE - PAR_TRAIN
PAR_LOSS_RTOL, PAR_ACC_POINTS, PAR_STEP_RTOL = 1e-3, 0.5, 1e-5
# one rank of the two-rank driver run: the driver's CLI entry point with
# the rows of every K2 launch and the K1 / K2 launch counts printed after
RANK_CHILD = r"""
import json, sys
import torch
torch.backends.cudnn.allow_tf32 = False
from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2
rows = []
launch = k2._launch
k2._launch = lambda x, k, r0, r1: rows.append([r0, r1]) or launch(x, k, r0,
                                                                   r1)
from graphlearninglayer_tpu_torch.train import fullysup
rec = fullysup.main(sys.argv[1:])
print("RANK_RESULT " + json.dumps(dict(
    step_loss=rec["step_loss"], test_acc=rec["test_acc"], mesh=rec["mesh"],
    evals=[{k: e[k] for k in ("n_nodes", "cg_iters", "cg_err", "route",
                              "solve_s", "encode_s")} for e in rec["eval"]],
    epoch_s=rec["epoch_s"], k1_launches=k1.fused_affinity_sym.launches,
    k2_launches=k2.fused_knn.launches, k2_rows=rows)), flush=True)
"""
# every CUDA source of the port, one nvcc each, started together
KERNEL_SOURCES = ("affinity_sym", "knn_topk", "ell_spmm", "row_sort",
                  "take_along")
# P3 (the ELL gather SpMM) against its plain version: per entry at most
# P3_REL_TOL max_i sum_s |val[i, s]| max |x| (another summation order)
P3_REL_TOL = 1e-6
P3_CLASSES = (10, 100)     # CIFAR-10's and CIFAR-100's l
# P1 and P2 at the probes' shapes: P1's 256 x 512 block (and 64 x 1,024),
# P2's six (m, n, axis) cases
P1_SHAPES = ((256, 512), (64, 1024))
P2_CASES = ((256, 128, 0), (8192, 128, 0), (128, 128, 1), (128, 1024, 1),
            (8, 8192, 1), (65536, 128, 0))
# P1's gated scale also above its one-cluster limit (262,144 elements), where
# it takes its two-kernel path; odd, so that the vectors leave a tail
P1_SCALE_LARGE = 1_000_003
# H100 SXM peaks from NVIDIA's data sheet, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# device_ms: the spin kernel's first length (about 10 ms at the H100's
# clock), and the memset that evicts the 50 MB L2 before a flushed launch
SPIN_CYCLES = 20_000_000
FLUSH_BYTES = 256 * 2**20
# kernel-name substrings that sort the profile's device time into groups;
# the first group that matches takes the kernel
PROFILE_GROUPS = (
    # K1 (affinity_sym_kernel) and K3 (affinity_tile_kernel)
    ("k1_affinity", ("affinity_sym_kernel", "affinity_tile_kernel")),
    ("conv", ("xmma", "implicit_gemm", "conv", "dgrad", "wgrad", "fft")),
    ("conv_layout", ("nhwctonchw", "nchwtonhwc")),
    ("batchnorm", ("batchnorm", "batch_norm", "bn_")),
    ("cholesky_solve", ("potrf", "trsm", "potrs", "cholesky", "syrk",
                        "cusolver", "magma", "trsv")),
    ("topk_sort", ("topk", "sort", "radix", "bitonic")),
    ("gemm", ("gemm", "cutlass", "sm90_")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise",)),
)
# the same for the transductive solve, which runs no convolution: its only
# GEMM is the BSR tile product
SOLVE_GROUPS = (
    ("k2_knn", ("knn_",)),
    ("bsr_tile_matmul", ("gemm", "xmma", "cutlass", "sm90_")),
    ("scatter_gather", ("index", "scatter", "gather")),
    ("sort_histogram", ("sort", "radix", "histogram")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "fill")),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, from CUDA events around each
    call, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 100, flush: bool = False) -> float:
    """Device ms of one ``fn()``: CUDA events around ``reps`` back-to-back
    calls, over ``reps``, after warm-up.  The calls are enqueued behind a
    spin kernel, so the device runs them back to back and the host's work
    in each call (checks, allocation, the launch itself) stays outside the
    window; that the device had not reached the first call when the last
    was enqueued is checked, with a longer spin if not.  With ``flush``
    each call has its own events, and a memset of FLUSH_BYTES before each
    evicts the L2."""
    import torch

    for _ in range(3):
        fn()
    scratch = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
               if flush else None)
    cycles = SPIN_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        events = []
        for _ in range(reps if flush else 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if flush:
                scratch.zero_()
            start.record()
            for _ in range(1 if flush else reps):
                fn()
            end.record()
            events.append((start, end))
        ahead = not events[0][0].query()
        torch.cuda.synchronize()
        if ahead:
            return sum(a.elapsed_time(b) for a, b in events) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the host never got ahead of the device")


def k1_bound_ms(n: int, d: int) -> tuple[float, str]:
    """Least time for K1's and K3's work: x, eps and M read once, W
    written once; K3's W is symmetric in d2, so its dot products need only
    the Gram matrix's upper triangle, n (n + 1) d f32 operations.  K1 does
    fewer (3 d a kept entry, at most 2 k n of them), so the bytes bound
    both at every shape the smoke times."""
    nbytes = 4 * (n * d + n + n * n) + 4 * n * n
    ops = n * (n + 1) * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def k2_bound_ms(n: int, d: int, k: int,
                m: int | None = None) -> tuple[float, str]:
    """Least time for K2's work: d2 is symmetric, so the dot products need
    only the Gram matrix's upper triangle, n (n + 1) / 2 d FMA of two f32
    operations each, against x read once and nbr (int64) and dist2 written
    once.  For a range of m query rows (a rank's share): the triangle of
    the m x m block and the m x (n - m) rest, and m rows of output."""
    m = n if m is None else m
    nbytes = 4 * n * d + (8 + 4) * m * k
    ops = (m * (m + 1) + 2 * m * (n - m)) * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def clustered_features(n: int, seed: int, d: int = 128, l: int = 10):
    """The clustered geometry of benchmarks/bench_transductive.py (10
    centers of scale 2, unit noise, rows L2-normalized), float32 on the
    CPU, with the cluster labels."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(l, d)).astype(np.float32) * 2.0
    lab = rng.integers(0, l, n)
    x = centers[lab] + rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x), lab


def normalized_features(n: int, d: int, seed: int, min_gap: float = 0.0):
    """L2-normalized float32 features (CPU), redrawn until every row's K-th
    and (K+1)-th squared neighbor distances differ by at least ``min_gap``
    (in float64), so that float32 and float64 KNN pick the same graph."""
    import torch

    while True:
        gen = torch.Generator().manual_seed(seed)
        x = torch.nn.functional.normalize(torch.randn(n, d, generator=gen),
                                          dim=1)
        x64 = x.double()
        d2 = torch.cdist(x64, x64).pow(2)
        d2.fill_diagonal_(-1.0)
        s = torch.sort(d2, dim=1).values
        if min_gap <= 0 or (s[:, K] - s[:, K - 1]).min().item() >= min_gap:
            return x, seed
        seed += 1


def phase_device():
    import torch

    card = card_line()
    # matrix products in full float32 (PyTorch's default, set explicitly);
    # each training run sets cuDNN's TF32 flag for its convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_tf32=torch.backends.cudnn.allow_tf32)
    return card


def phase_build():
    from graphlearninglayer_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    built = _build.build(*KERNEL_SOURCES)
    wall = time.perf_counter() - t0
    for name, result in built.items():
        seconds, log = result if result is not None else (None, "")
        emit("build", source=f"{name}.cu", wall_s=round(wall, 3),
             compiled=result is not None, nvcc_s=seconds,
             nvcc_flags=list(_build.NVCC_FLAGS),
             ptxas=[ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "smem", "spill"))])


def k1_inputs(n: int, d: int = 128) -> tuple:
    """K1's inputs at n on the card: unit features (d=128), and the eps and
    raw KNN indicator (k=K) of the port's dense graph over them."""
    from graphlearninglayer_tpu_torch.ops.dense_mode import build_dense_graph

    x, _ = normalized_features(n, d, SEED + n)
    x = x.to("cuda")
    g = build_dense_graph(x, K)
    return x, g.eps, g.m_raw


def k3_inputs(n: int, eps_mode: str = "auto") -> tuple:
    """K3's inputs at n on the card: unit features (d=128), eps from their
    K-th neighbor (or 1.5 for "fixed") and the KNN mask of the port's knn
    without self loops (raw, so asymmetric)."""
    import torch

    from graphlearninglayer_tpu_torch.ops.knn import knn

    x, _ = normalized_features(n, 128, SEED + 3 * n)
    x = x.to("cuda")
    nbr, d2 = knn(x, K)
    mask = torch.zeros((n, n), device=x.device).scatter_(1, nbr, 1.0)
    mask.fill_diagonal_(0.0)
    eps = (torch.sqrt(d2[:, -1]).clamp_min(1e-6) if eps_mode == "auto"
           else torch.full((n,), 1.5, device=x.device))
    return x, eps.contiguous(), mask


def phase_k1():
    import torch

    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2

    result = {}
    for n in (1500, 300):
        args = k1_inputs(n)
        m_raw = args[2]
        got = k1.fused_affinity_sym(*args)
        want = k1.fused_affinity_sym_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= K1_TOL, f"K1 max |kernel - plain| {err} <= {K1_TOL} "
              f"at n={n}")
        check(bool(torch.equal(got, got.T)), f"K1's W is symmetric at n={n}")
        times = affinity_times(lambda: k1.fused_affinity_sym(*args),
                               lambda: k1.fused_affinity_sym_plain(*args),
                               n, plain_syncs=True)
        emit("k1", n=n, d=128, k=K, max_abs_err=err, tol=K1_TOL, **times,
             edges=int(torch.maximum(m_raw, m_raw.T).sum().item()))
        result[n] = dict(max_abs_err=err, **times)
    result["dup"] = k1_duplicated_rows()
    return result


def duplicated_rows(x, n_copies: int = 30):
    """``x`` with rows 10.. copied onto rows n / 2.. (``n_copies`` each),
    and the (source, copy) index tensors."""
    import torch

    n = x.shape[0]
    src = torch.arange(10, 10 + n_copies, device=x.device)
    dup = torch.arange(n // 2, n // 2 + n_copies, device=x.device)
    x = x.clone()
    x[dup] = x[src]
    return x, src, dup


def k1_duplicated_rows() -> dict:
    """K1 and its plain version on k1_inputs' features at n=1500 with 30
    rows copied onto others (each the other's nearest neighbor): W exactly
    0 on every copied pair and its transpose in both, since both form a
    kept entry's d2 from the rows' difference; K1_TOL apart elsewhere."""
    import torch

    from graphlearninglayer_tpu_torch.ops.dense_mode import build_dense_graph
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2

    x, src, dup = duplicated_rows(k1_inputs(1500)[0])
    g = build_dense_graph(x, K)
    args = (x, g.eps, g.m_raw)
    got = k1.fused_affinity_sym(*args)
    want = k1.fused_affinity_sym_plain(*args)
    torch.cuda.synchronize()
    kept = bool(g.m_raw[dup, src].all() and g.m_raw[src, dup].all())
    zero = {name: not bool(w[dup, src].any() or w[src, dup].any())
            for name, w in (("kernel", got), ("plain", want))}
    err = (got - want).abs().max().item()
    emit("k1_dup", n=1500, copies=len(src), pairs_are_knn_edges=kept,
         w_zero_on_pairs=zero, max_abs_err=err, tol=K1_TOL,
         d2_on_pairs=g.d2[dup, src].abs().max().item())
    check(kept, "each copied row is a KNN edge of its source")
    check(all(zero.values()), f"K1 and plain give W = 0 on copied pairs "
          f"({zero})")
    check(err <= K1_TOL, f"K1 within {K1_TOL} of plain with copied rows "
          f"({err})")
    return dict(max_abs_err=err)


def affinity_times(kernel, plain, n: int, plain_syncs: bool = False
                   ) -> dict:
    """K1's or K3's device times at n (d=128) beside the bound: ``ms`` over
    100 back-to-back launches, with M and W warm in the L2 (18 MB at
    n=1500); ``ms_l2_flushed`` over 20 launches, each after an L2 flush;
    ``call_ms`` one call with the wrapper's host work inside the events;
    ``plain_ms`` the plain version over 20 back-to-back calls, or, where
    it waits on the device itself (``plain_syncs``: K1's, whose
    ``torch.nonzero`` finds the kept entries), the median of 20 calls
    each between its own events."""
    ms = device_ms(kernel)
    bound_ms, bound_by = k1_bound_ms(n, 128)
    plain_ms = (cuda_ms(plain, reps=20) if plain_syncs
                else device_ms(plain, reps=20))
    return dict(ms=ms, ms_l2_flushed=device_ms(kernel, reps=20, flush=True),
                call_ms=cuda_ms(kernel), plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms)


def phase_k2():
    """K2 against its plain version.  Under float32 rounding a row can swap
    a neighbor across the k-th/(k+1)-th boundary only where the plain gap
    there is below the two entries' summed errors, at most twice the
    measured max |dist2 diff|: that band sets the boundary-tie set.  Every
    row whose neighbor sets differ must lie in it and differ by exactly one
    neighbor, the dropped one and the added one both within the band of
    the plain (k+1)-th distance; at most K2_MAX_DIFFER of the rows may
    differ."""
    import torch

    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2
    from graphlearninglayer_tpu_torch.ops.precision import full_f32

    dev = torch.device("cuda")
    result = {}
    for n, k in ((EVAL_N, EVAL_K), (1500, 25)):
        x = clustered_features(n, SEED + n)[0].to(dev)
        nbr, dist2 = k2.fused_knn(x, k)
        pn, pd = k2.fused_knn_plain(x, k + 1, 2048)
        torch.cuda.synchronize()
        bar = k2_against_plain(nbr, dist2, pn, pd, 0, f"n={n}")
        err, tie, gap, pd = bar["err"], bar["tie"], bar["gap"], pd[:, :k]
        big = n > 10_000
        ms = cuda_ms(lambda: k2.fused_knn(x, k), reps=5 if big else 25,
                     warmup=1)
        plain_ms = cuda_ms(lambda: k2.fused_knn_plain(x, k, 2048),
                           reps=3 if big else 25, warmup=1)

        def library():
            with full_f32():
                torch.topk(torch.cdist(x, x), k, dim=1, largest=False)

        library_ms = cuda_ms(library, reps=3 if big else 25, warmup=1)
        bound_ms, bound_by = k2_bound_ms(n, x.shape[1], k)
        emit("k2", n=n, d=x.shape[1], k=k, max_abs_err=err, tol=K2_TOL,
             tie_band=bar["band"], tie_rows=int(tie.sum()),
             tie_share=tie.float().mean().item(),
             tie_rows_rel_1e5=int((gap <= 1e-5 * pd[:, k - 1]).sum()),
             differing_rows=bar["differing_rows"],
             differing_outside_ties=bar["differing_outside_ties"],
             one_boundary_swap=bar["one_boundary_swap"],
             swap_gap_max=bar["swap_gap"],
             self_first=bar["self_first"], ms=ms, plain_ms=plain_ms,
             library_ms=library_ms,
             library="torch.cdist + torch.topk (two calls, full n x n)",
             bound_ms=bound_ms, bound_by=bound_by,
             bound_share=bound_ms / ms,
             tflops_both_triangles=2 * n * n * x.shape[1] / (ms * 1e9))
        result[n] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        # the row ranges of a two-rank sharded build: each half bit for bit
        # the full call's rows, and against the plain version's range
        halves = {}
        for r0, r1 in ((0, n // 2), (n // 2, n)):
            hn, hd = k2.fused_knn(x, k, rows=(r0, r1))
            qn, qd = k2.fused_knn_plain(x, k + 1, 2048, rows=(r0, r1))
            torch.cuda.synchronize()
            same = (torch.equal(hn, nbr[r0:r1])
                    and torch.equal(hd, dist2[r0:r1]))
            hbar = k2_against_plain(hn, hd, qn, qd, r0,
                                    f"n={n}, rows {r0}:{r1}")
            hms = cuda_ms(lambda: k2.fused_knn(x, k, rows=(r0, r1)),
                          reps=5 if big else 25, warmup=1)
            hb_ms, hb_by = k2_bound_ms(n, x.shape[1], k, r1 - r0)
            halves[f"{r0}:{r1}"] = dict(
                bitwise_equal_full=same, ms=hms, bound_ms=hb_ms,
                bound_by=hb_by, bound_share=hb_ms / hms,
                max_abs_err=hbar["err"],
                differing_rows=hbar["differing_rows"])
            check(same, f"K2 rows {r0}:{r1} equal the full call's bit for "
                  f"bit at n={n}")
            del hn, hd, qn, qd
        emit("k2_rows", n=n, k=k, ranges=halves)
        result[n]["rows"] = halves
        del x, nbr, dist2, pn, pd, gap
    torch.cuda.empty_cache()
    result["dup"] = k2_duplicated_rows()
    return result


def k2_duplicated_rows() -> dict:
    """K2 and its plain version on clustered features at n=1500, k=25 with
    30 rows copied onto others: each copy in its source's second slot and
    back, at d2 exactly 0 in both (each kept edge's d2 from the rows'
    difference), self at 0; on the rows whose lists are equal the d2 of
    the two within 1e-6, both being the difference form."""
    import torch

    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2

    x, src, dup = duplicated_rows(
        clustered_features(1500, SEED + 7)[0].to("cuda"))
    nbr, dist2 = k2.fused_knn(x, 25)
    pn, pd = k2.fused_knn_plain(x, 25, 2048)
    torch.cuda.synchronize()
    found = {}
    for name, (n_, d_) in (("kernel", (nbr, dist2)), ("plain", (pn, pd))):
        found[name] = bool(torch.equal(n_[src, 1], dup)
                           and torch.equal(n_[dup, 1], src)
                           and not d_[src, :2].any() and not d_[dup, :2].any()
                           and not d_[:, 0].any())
    same = (nbr == pn).all(1)
    err = (dist2[same] - pd[same]).abs().max().item()
    emit("k2_dup", n=1500, k=25, copies=len(src), copies_at_zero=found,
         rows_equal_lists=int(same.sum()), max_abs_err=err, tol=1e-6)
    check(all(found.values()), f"K2 and plain put each copy second at d2 "
          f"0 ({found})")
    check(same.float().mean().item() >= 0.99,
          f"K2 and plain lists equal on {int(same.sum())} of 1500 rows")
    check(err <= 1e-6, f"K2 d2 within 1e-6 of plain on equal lists ({err})")
    return dict(max_abs_err=err)


def k2_against_plain(nbr, dist2, pn, pd, row0: int, what: str) -> dict:
    """K2's lists of rows row0.. against the plain version's, which has one
    more column (k + 1) unless k is every row of x.  Under float32 rounding a row can swap a neighbor
    across the k-th/(k+1)-th boundary only where the plain gap there is
    below twice the measured max |dist2 diff|: the boundary-tie set.  Checks
    self first, the error bar, that every differing row lies in the tie set
    and swaps exactly one neighbor at the boundary, and that at most
    K2_MAX_DIFFER of the rows differ."""
    import torch

    n, k = nbr.shape
    # the plain (k+1)-th distance; with k = every row of x there is none,
    # and no neighbor can cross the boundary
    edge = (pd[:, k] if pd.shape[1] > k
            else torch.full_like(pd[:, 0], float("inf")))
    pn, pd = pn[:, :k], pd[:, :k]
    err = (dist2 - pd).abs().max().item()
    band = 2.0 * err
    gap = edge - pd[:, k - 1]
    tie = gap <= band
    differ = ~(torch.sort(nbr, 1).values == torch.sort(pn, 1).values).all(1)
    rows = differ.nonzero().squeeze(1).tolist()
    swap_gap = 0.0
    one_boundary_swap = True
    for r in rows:
        added = ~torch.isin(nbr[r], pn[r])
        dropped = ~torch.isin(pn[r], nbr[r])
        if int(added.sum()) != 1 or int(dropped.sum()) != 1:
            one_boundary_swap = False
            continue
        off = max((edge[r] - pd[r][dropped]).abs().item(),
                  (dist2[r][added] - edge[r]).abs().item())
        swap_gap = max(swap_gap, off)
        one_boundary_swap &= off <= band
    self_first = bool((nbr[:, 0] == torch.arange(
        row0, row0 + n, device=nbr.device)).all())
    check(len(rows) <= K2_MAX_DIFFER * n,
          f"K2 neighbor sets differ on {len(rows)} of {n} rows at {what}")
    check(self_first, f"K2 puts self first at {what}")
    check(err <= K2_TOL, f"K2 max |dist2 diff| {err} <= {K2_TOL} at {what}")
    check(not bool((differ & ~tie).any()),
          f"K2 neighbor sets equal the plain ones outside the tie set at "
          f"{what}")
    check(one_boundary_swap, f"K2's differing rows each swap exactly one "
          f"neighbor at the boundary at {what} ({swap_gap} > {band})")
    return dict(err=err, band=band, tie=tie, gap=gap,
                differing_rows=len(rows),
                differing_outside_ties=int((differ & ~tie).sum()),
                one_boundary_swap=one_boundary_swap, swap_gap=swap_gap,
                self_first=self_first)


def phase_op():
    import torch

    from graphlearninglayer_tpu_torch.ops import laplace_learning
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2

    n, k_lab, l = N_BASE + N_BATCH, N_BASE, NUM_CLASSES
    x, seed = normalized_features(n, 128, SEED, min_gap=2e-6)
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, l, (k_lab,), generator=gen)
    y = torch.nn.functional.one_hot(labels, l).double()
    gbar = torch.randn(n - k_lab, l, generator=gen, dtype=torch.float64)

    def run(xv, yv, gv):
        xv = xv.clone().requires_grad_(True)
        stats = {}
        pred = laplace_learning(xv, yv, tau=TAU, epsilon="auto", k=K,
                                stats=stats)
        (pred * gv).sum().backward()
        return pred.detach(), xv.grad, stats

    want_pred, want_gx, _ = run(x.double(), y, gbar)
    dev = torch.device("cuda")
    xc, yc, gc = x.to(dev), y.float().to(dev), gbar.float().to(dev)
    before = k1.fused_affinity_sym.launches
    pred, gx, stats = run(xc, yc, gc)
    torch.cuda.synchronize()
    launches = k1.fused_affinity_sym.launches - before
    pred_err = (pred.double().cpu() - want_pred).abs().max().item()
    gx_rel = ((gx.double().cpu() - want_gx).abs().max()
              / want_gx.abs().max()).item()
    ms = cuda_ms(lambda: run(xc, yc, gc), reps=20)
    emit("op", n=n, k_lab=k_lab, l=l, d=128, k=K, tau=TAU, input_seed=seed,
         pred_max_abs_err=pred_err, pred_tol=1e-4, grad_max_rel_err=gx_rel,
         grad_tol=1e-3, chol_info=int(stats["chol_info"]),
         k1_launches=launches, fwd_bwd_ms=ms)
    check(launches == 1, f"K1 launched once in the op (got {launches})")
    check(int(stats["chol_info"]) == 0, "Cholesky info == 0")
    check(pred_err <= 1e-4, f"op pred err {pred_err} <= 1e-4")
    check(gx_rel <= 1e-3, f"op grad rel err {gx_rel} <= 1e-3")


def _new_state(dtype, device):
    import torch

    from graphlearninglayer_tpu_torch.models import BuildNet
    from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                    make_lr_schedule)

    model = BuildNet("resnet18", head="mlp", feat_dim=128,
                     num_classes=NUM_CLASSES, dtype=dtype,
                     generator=torch.Generator().manual_seed(SEED))
    schedule = make_lr_schedule(0.01, epochs=50, steps_per_epoch=40,
                                cosine=True)
    return create_train_state(model, schedule, device=device)


def _train_run(label, dtype, cudnn_tf32, steps, data, rng):
    import torch

    from graphlearninglayer_tpu_torch.data import CHANNEL_STATS
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2
    from graphlearninglayer_tpu_torch.train import (make_gl_train_step,
                                                    metrics_to_host)

    images, labels = data
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    state = _new_state(dtype, "cuda")
    step = make_gl_train_step(NUM_CLASSES, tau=TAU, epsilon="auto", k=K,
                              norm=CHANNEL_STATS["cifar10"], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = k1.fused_affinity_sym.launches
    times, losses = [], []
    for i in range(steps):
        idx = rng.permutation(len(images))[:N_BASE + N_BATCH]
        b, t = idx[:N_BASE], idx[N_BASE:]
        t0 = time.perf_counter()
        state, metrics, scores = step(state, images[b], labels[b],
                                      images[t], labels[t])
        host = metrics_to_host(metrics)
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(host["loss"])
        emit("train_step", run=label, step=i, loss=host["loss"],
             acc=host["acc"], chol_info=host["chol_info"],
             params_finite=host["params_finite"], ms=times[-1])
        check(math.isfinite(host["loss"]), f"{label} step {i}: finite loss")
        check(host["params_finite"], f"{label} step {i}: params finite")
        check(host["chol_info"] == 0, f"{label} step {i}: Cholesky info 0")
        check(tuple(scores.shape) == (N_BATCH,), "scores shape")
    launches = k1.fused_affinity_sym.launches - before
    check(launches == steps, f"{label}: K1 launched once per step "
          f"({launches} in {steps} steps)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    median = statistics.median(times[1:])
    emit("train", run=label, cudnn_tf32=cudnn_tf32, matmul_tf32=False,
         steps=steps, median_ms_per_step=median,
         first_step_ms=times[0], peak_mem_gib=peak, k1_launches=launches,
         first_loss=losses[0], last_loss=losses[-1])
    return state, step, median


def phase_parity():
    """One train step at 40 + 160 random-byte images from identical weights
    on the card and on the CPU, with TF32 off for both convolutions and
    matmuls.  The parameters are compared relative to the largest update:
    float32 gradients of a freshly initialised ResNet-18 carry errors of up
    to a few percent (each framework's float32 gradient against a float64
    one, tests/test_torch_train_step.py), so the bar is 2% of the update."""
    import numpy as np
    import torch

    from graphlearninglayer_tpu_torch.data import CHANNEL_STATS
    from graphlearninglayer_tpu_torch.train import (make_gl_train_step,
                                                    metrics_to_host)

    def flat(state):
        return torch.cat([p.detach().double().cpu().reshape(-1)
                          for p in state.model.parameters()])

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 2)
    images = rng.integers(0, 256, (200, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, NUM_CLASSES, 200)
    out = {}
    for device in ("cuda", "cpu"):
        state = _new_state(torch.float32, device)
        before = flat(state)
        step = make_gl_train_step(NUM_CLASSES, tau=TAU, epsilon="auto",
                                  k=K, norm=CHANNEL_STATS["cifar10"],
                                  device=device)
        state, metrics, scores = step(state, images[:40], labels[:40],
                                      images[40:], labels[40:])
        out[device] = (metrics_to_host(metrics), scores.double().cpu(),
                       flat(state), before)
    (mc, sc, pc, _), (mh, sh, ph, p0) = out["cuda"], out["cpu"]
    loss_rel = abs(mc["loss"] - mh["loss"]) / abs(mh["loss"])
    score_err = (sc - sh).abs().max().item()
    param_err = (pc - ph).abs().max().item()
    update = (ph - p0).abs().max().item()
    emit("parity", base=40, batch=160, cudnn_tf32=False, matmul_tf32=False,
         loss_card=mc["loss"], loss_cpu=mh["loss"], loss_rel_err=loss_rel,
         loss_tol=1e-4, score_max_abs_err=score_err, score_tol=1e-3,
         param_max_abs_err=param_err, max_update=update,
         param_err_over_update=param_err / update, param_tol="2% of update")
    check(loss_rel <= 1e-4, f"card/CPU loss rel err {loss_rel} <= 1e-4")
    check(score_err <= 1e-3, f"card/CPU score err {score_err} <= 1e-3")
    check(param_err <= 0.02 * update,
          f"card/CPU param err {param_err} <= 2% of the update {update}")


def _union(spans) -> float:
    """Total length covered by sorted (start, end) spans."""
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_window(run, steps: int, groups=PROFILE_GROUPS) -> dict:
    """torch.profiler over ``steps`` calls of ``run()``: device time by
    kernel and kernel group, and the device's busy share of the host-clock
    window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = _union(sorted((e.time_range.start, e.time_range.end)
                         for e in kernels))
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    by_group: dict[str, float] = {}
    for name, t in by_name.items():
        group = next((g for g, keys in groups
                      if any(k in name.lower() for k in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + t
    return dict(
        wall_ms_per_step=wall_us / 1e3 / steps,
        device_busy_ms_per_step=busy / 1e3 / steps,
        kernel_ms_per_step=total / 1e3 / steps,
        busy_share=busy / wall_us if kernels else "not measured",
        groups_ms_per_step={g: t / 1e3 / steps for g, t in
                            sorted(by_group.items(), key=lambda kv: -kv[1])},
        top_kernels=[{"name": n[:90], "ms_per_step": t / 1e3 / steps,
                      "share": t / total} for n, t in top])


def phase_profile(state, step, data, rng, steps=3) -> float:
    """Where a warm f32 train step (TF32 off) spends device time; returns
    K1's in-step device ms per launch, which must be above zero."""
    import torch

    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2

    images, labels = data
    torch.backends.cudnn.allow_tf32 = False
    batches = iter([rng.permutation(len(images))[:N_BASE + N_BATCH]
                    for _ in range(steps)])

    def run():
        idx = next(batches)
        b, t = idx[:N_BASE], idx[N_BASE:]
        step(state, images[b], labels[b], images[t], labels[t])

    before = k1.fused_affinity_sym.launches
    prof = profile_window(run, steps)
    launches = k1.fused_affinity_sym.launches - before
    k1_ms = prof["groups_ms_per_step"].get("k1_affinity", 0.0) * steps
    in_step_ms = k1_ms / launches if launches else 0.0
    emit("profile", steps=steps, cudnn_tf32=False, matmul_tf32=False,
         k1_launches=launches, k1_in_step_ms=in_step_ms, **prof)
    check(launches == steps, f"K1 launched once a profiled step "
          f"({launches} in {steps})")
    check(in_step_ms > 0, "the profile's k1_affinity group reads K1's "
          "device time (a kernel rename would leave it at 0)")
    return in_step_ms


def phase_train():
    """The training main path; returns K1's launches in it, the float32
    state it trained, the TF32 run's median ms per step and K1's in-step
    device ms from the profile."""
    import numpy as np
    import torch

    from graphlearninglayer_tpu_torch.data import (CHANNEL_STATS,
                                                   synthetic_dataset)
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2
    from graphlearninglayer_tpu_torch.train import make_gl_eval_step

    spec = synthetic_dataset(num_classes=NUM_CLASSES, image_shape=(32, 32, 3),
                             n_train=4000, n_test=N_BATCH, seed=SEED)
    data = (spec.train_images, spec.train_labels)
    rng = np.random.default_rng(SEED)

    k1.fused_affinity_sym.launches = 0
    f32_state, f32_step, _ = _train_run("f32", torch.float32, False,
                                        F32_STEPS, data, rng)
    _, _, tf32_ms = _train_run("tf32", torch.float32, True, TF32_STEPS, data,
                               rng)
    state, _, _ = _train_run("bf16", torch.bfloat16, False, BF16_STEPS, data,
                             rng)
    eval_step = make_gl_eval_step(NUM_CLASSES, tau=TAU, epsilon="auto", k=K,
                                  norm=CHANNEL_STATS["cifar10"],
                                  device="cuda")
    base = rng.permutation(len(spec.train_images))[:N_BASE]
    pred = eval_step(state, spec.train_images[base], spec.train_labels[base],
                     spec.test_images)
    acc = (pred.cpu().numpy() == spec.test_labels).mean()
    launches = k1.fused_affinity_sym.launches
    check(launches == F32_STEPS + TF32_STEPS + BF16_STEPS + 1,
          f"K1 launched once per train and eval step ({launches})")
    check(tuple(pred.shape) == (N_BATCH,), "eval prediction shape")
    emit("eval", base=N_BASE, test=N_BATCH, acc=float(acc),
         chance=1.0 / NUM_CLASSES)
    emit("knn_select", **knn_selection_times())
    in_step_ms = phase_profile(f32_state, f32_step, data, rng)
    return launches, f32_state, tf32_ms, in_step_ms


def knn_selection_times() -> dict:
    """The exact KNN's selection by (d2, index), ``smallest_k``, device ms
    beside its two routes, a stable torch.sort of each row (sliced) and a
    torch.topk whose ties are repaired, and beside a bare torch.topk of
    the float32 d2 (the selection before the tie rule, which leaves the
    order of equal distances open): at the train step's shape (1,500 x
    1,500, k = 25), at a row width above smallest_k's SORT_COLS (2,048 x
    8,192, k = 50) and at one panel of the 60,250-node plain route (2,048
    x 60,250, k = 50).  Both routes' lists must equal the stable sort's.
    Median ms of CUDA events around each call (``cuda_ms``)."""
    import torch

    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2
    from graphlearninglayer_tpu_torch.ops.knn import pairwise_dist2
    from graphlearninglayer_tpu_torch.ops.precision import full_f32

    out = {}
    for rows, n, k in ((N_BASE + N_BATCH, N_BASE + N_BATCH, K),
                       (2048, 2 * k2.SORT_COLS, EVAL_K),
                       (2048, EVAL_N, EVAL_K)):
        x = clustered_features(n, SEED + 7)[0].cuda()
        with full_f32():
            d2 = pairwise_dist2(x[:rows], x)
        own = torch.arange(rows, device="cuda")
        d2[own, own] = -1.0
        tie = torch.arange(n, device="cuda")
        ways = {
            "smallest_k": lambda: k2.smallest_k(d2, k),
            "by_sort": lambda: k2.select_by_sort(d2, k, tie),
            "by_topk": lambda: k2.select_by_topk(d2, k, tie),
            "topk_f32": lambda: torch.topk(d2, k, dim=1, largest=False,
                                           sorted=True)}
        want = torch.sort(d2, dim=1, stable=True).indices[:, :k]
        for name in ("smallest_k", "by_topk"):
            got = ways[name]()
            got = got[1] if name == "smallest_k" else got
            check(torch.equal(got, want), f"{name} equals the stable sort's "
                  f"lists at {rows} x {n}")
        # CUDA events around each call (the repaired top-k waits on one
        # host sync, so calls cannot be queued back to back)
        out[f"{rows}x{n}"] = dict(k=k, **{f"{name}_ms": cuda_ms(fn, reps=20)
                                          for name, fn in ways.items()})
        del x, d2
    torch.cuda.empty_cache()
    return out


def phase_solve():
    """The cached 60,250-node solve (the production configuration of
    benchmarks/bench_transductive.py): two warm-up and three timed solves
    on distinct inputs through one EvalGraphCache, then one profiled."""
    import torch

    from graphlearninglayer_tpu_torch.ops import (EvalGraphCache,
                                                  one_hot_encode,
                                                  transductive_laplace)
    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2

    dev = torch.device("cuda")
    x, lab = clustered_features(EVAL_N, SEED + 1)
    x = x.to(dev)
    y = one_hot_encode(torch.as_tensor(lab[:EVAL_BASE]), NUM_CLASSES).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = [x + 1e-4 * torch.randn(x.shape, generator=gen, device=dev)
          for _ in range(6)]
    cache = EvalGraphCache()

    def solve(xi):
        return transductive_laplace(xi, y, knn_num=EVAL_K, tau=EVAL_TAU,
                                    return_info=True, cache=cache)

    runs = []
    torch.cuda.reset_peak_memory_stats()
    for xi in xs[:5]:
        before = k2.fused_knn.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred, iters, err = solve(xi)
        torch.cuda.synchronize()
        runs.append(dict(s=time.perf_counter() - t0, cg_iters=iters,
                         cg_err=err, converged=err <= 1e-10,
                         mode="bsr" if cache.perm is not None else "sorted",
                         smax=cache.smax, ovf_cap=cache.ovf_cap,
                         k2_launches=k2.fused_knn.launches - before))
        if err > 1e-10:      # hit max_iter: reported, not repeated
            break
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed = [r["s"] for r in runs[2:]]
    acc = (pred.argmax(1).cpu().numpy() == lab[EVAL_BASE:]).mean()
    prof = profile_window(lambda: solve(xs[5]), 1, SOLVE_GROUPS)
    emit("solve", n=EVAL_N, d=x.shape[1], k=EVAL_K, l=NUM_CLASSES,
         tau=EVAL_TAU, warmups=2, runs=runs,
         s_per_solve=statistics.mean(timed) if timed else "not measured",
         peak_mem_gib=peak, acc=float(acc), profile=prof)
    check(tuple(pred.shape) == (EVAL_N - EVAL_BASE, NUM_CLASSES),
          "solve output shape")
    check(bool(torch.isfinite(pred).all()), "finite scores")
    check(all(r["mode"] == "bsr" for r in runs), "the solve ran in bsr mode")
    check(all(r["k2_launches"] == 1 for r in runs), "one K2 launch a solve")


def phase_solve_parity():
    """The solve at PARITY_N nodes on the card (float32) against the port on
    the CPU (float64), on the same clustered features."""
    import torch

    from graphlearninglayer_tpu_torch.ops import (one_hot_encode,
                                                  transductive_laplace)

    x, lab = clustered_features(PARITY_N, SEED + 2)
    y = one_hot_encode(torch.as_tensor(lab[:EVAL_BASE]), NUM_CLASSES)
    kw = dict(knn_num=EVAL_K, tau=EVAL_TAU, return_info=True)
    card, it_card, err_card = transductive_laplace(x.cuda(), y.cuda(), **kw)
    t0 = time.perf_counter()
    cpu, it_cpu, err_cpu = transductive_laplace(x.double(), y.double(), **kw)
    cpu_s = time.perf_counter() - t0
    card = card.double().cpu()
    agree = (card.argmax(1) == cpu.argmax(1)).double().mean().item()
    rel = ((card - cpu).abs().max() / cpu.abs().max()).item()
    emit("solve_parity", n=PARITY_N, k=EVAL_K, tau=EVAL_TAU,
         argmax_agreement=agree, agreement_tol=0.999,
         max_abs_err_over_max=rel, rel_tol=1e-3, cg_iters_card=it_card,
         cg_err_card=err_card, cg_iters_cpu=it_cpu, cg_err_cpu=err_cpu,
         cpu_f64_s=cpu_s)
    check(agree >= 0.999, f"card/CPU argmax agreement {agree} >= 0.999")
    check(rel <= 1e-3, f"card/CPU max |pred diff| {rel} <= 1e-3 max |pred|")


def p3_bound_ms(m: int, n: int, counted: int, used: int, l: int
                ) -> tuple[float, str]:
    """Least time for P3's work on this graph: val (float32) and nbr
    (int64) on the ``counted`` slots, each row's first count slots, 12
    bytes each, and the counts (int32), m 4; x read once, n l 4; out
    written once, m l 4; 2 l float32 operations a used slot (val != 0)."""
    nbytes = counted * 12 + m * 4 + n * l * 4 + m * l * 4
    return _bytes_or_ops(nbytes, 2 * used * l)


def p3_bound_ms_every_slot(m: int, n: int, s: int, used: int, l: int
                           ) -> tuple[float, str]:
    """The previous design's count of P3's work, which read every slot's
    value: val on all m S slots, nbr on the used ones, x and out once."""
    nbytes = m * s * 4 + used * 8 + n * l * 4 + m * l * 4
    return _bytes_or_ops(nbytes, 2 * used * l)


def l2_sector_bytes(cols, l: int) -> int:
    """Bytes of the 32-byte sectors that the rows ``cols`` of a float32
    (n, l) array span, one gather a row: what a design that fetches each
    used slot's row of x from L2 moves there at least."""
    start = cols.long() * (4 * l)
    sectors = (start + 4 * l - 1) // 32 - start // 32 + 1
    return 32 * int(sectors.sum())


def _bytes_or_ops(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def phase_ell() -> dict:
    """P3 on the eval's symmetric ELL at the solve phase's geometry (60,250
    clustered nodes, d=128, k=50, tau 1e-8; the graph built once): S, the
    overflow and one matvec's bound; for l = 10 and 100 the kernel against
    its plain version (P3_REL_TOL), its device ms per matvec over 100
    back-to-back launches (the iterate warm in L2), the plain version's,
    one torch.sparse CSR product's of the slots in use (the library call)
    and bsr_spmm's on the same graph (the port's default matvec: a
    yardstick, not a library call).  Then transductive_laplace(mode='ell'): s a solve (mean of 3
    after 2 warm-ups), CG iterations, residual <= 1e-10, >= 99.9% equal
    argmax against mode='bsr' on the same features, and P3 launched
    exactly CG iterations + 2 times a solve (the right-hand side, the
    start residual, one a CG step).  Returns the main numbers."""
    import torch

    from graphlearninglayer_tpu_torch.ops import (EvalGraphCache,
                                                  one_hot_encode,
                                                  transductive_laplace)
    from graphlearninglayer_tpu_torch.ops import graph as tg
    from graphlearninglayer_tpu_torch.ops.bsr import (bsr_plan_from_perm,
                                                      bsr_spmm,
                                                      build_bsr_mat)
    from graphlearninglayer_tpu_torch.ops.kernels import ell_spmm as p3

    dev = torch.device("cuda")
    x, lab = clustered_features(EVAL_N, SEED + 1)
    x = x.to(dev)
    y = one_hot_encode(torch.as_tensor(lab[:EVAL_BASE]), NUM_CLASSES).to(dev)
    n = EVAL_N
    # the graph once, and the ELL structure as mode='ell' builds it
    g = tg.build_graph(x, EVAL_K, "auto", tiled=True)
    w, _ = tg.edge_weights(g)
    cap = min(tg.ell_cap(int(tg.max_in_degree(g))), 512)
    ovf = int(tg.overflow_count(g, cap))
    ovf_cap = 0 if ovf == 0 else -(-ovf // 4096) * 4096
    ell = tg.build_sym_ell(g, w, cap, ovf_cap)
    s_slots = ell.nbr.shape[1]
    in_use = ell.val != 0
    used = int(in_use.sum())
    counted = int(ell.cnt.sum())
    past = torch.arange(s_slots, device=dev)[None, :] >= ell.cnt[:, None]
    check(not bool((past & in_use).any()),
          "no slot past a row's count holds a value")
    del past
    # the BSR tiles of the same graph, as the default solve plans them
    cache = EvalGraphCache()
    bsr_pred, bsr_iters, bsr_err = transductive_laplace(
        x, y, knn_num=EVAL_K, tau=EVAL_TAU, return_info=True, cache=cache)
    check(cache.perm is not None, "the bsr solve tiled the graph")
    plan = bsr_plan_from_perm(g, cache.perm, 256)
    mat = build_bsr_mat(plan, tg.edge_weights(plan.gp)[0], 256, cache.smax,
                        cache.ovf_cap)
    # the library's CSR holds the slots in use only (no stored zeros)
    csr = torch.sparse_csr_tensor(
        torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                   in_use.sum(1).cumsum(0)]),
        ell.nbr[in_use], ell.val[in_use], size=(n, n))
    per_l = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for l in P3_CLASSES:
        xl = torch.randn((n, l), generator=gen, device=dev)
        got = p3.ell_gather_spmm(ell.nbr, ell.val, xl, ell.cnt)
        want = p3.ell_gather_spmm_plain(ell.nbr, ell.val, xl, ell.cnt)
        lib = torch.sparse.mm(csr, xl)
        full = tg.ell_spmm(ell, xl)
        bsr = bsr_spmm(mat, xl[plan.perm], n)[plan.inv]
        torch.cuda.synchronize()
        bar = (P3_REL_TOL * ell.val.abs().sum(1).max().item()
               * xl.abs().max().item())
        err = (got - want).abs().max().item()
        check(err <= bar, f"P3 within {bar} of plain at l={l} ({err})")
        bound_ms, bound_by = p3_bound_ms(n, n, counted, used, l)
        ms = device_ms(lambda: p3.ell_gather_spmm(ell.nbr, ell.val, xl,
                                                  ell.cnt))
        sector_bytes = l2_sector_bytes(ell.nbr[in_use], l)
        per_l[l] = dict(
            max_abs_err=err, tol=bar, ms=ms,
            ms_l2_flushed=device_ms(lambda: p3.ell_gather_spmm(
                ell.nbr, ell.val, xl, ell.cnt), reps=20, flush=True),
            plain_ms=cuda_ms(lambda: p3.ell_gather_spmm_plain(
                ell.nbr, ell.val, xl, ell.cnt), reps=3, warmup=1),
            library_ms=device_ms(lambda: torch.sparse.mm(csr, xl), reps=20),
            library="torch.sparse.mm of the ELL slots in use as a CSR "
                    "matrix",
            library_max_abs_err=(lib - want).abs().max().item(),
            bsr_spmm_ms=device_ms(lambda: bsr_spmm(mat, xl, n), reps=20),
            bsr_spmm="ops/bsr.py::bsr_spmm on the same graph's tiles: the "
                     "port's default matvec, a yardstick, not a library call",
            bsr_vs_ell_spmm_max_abs=(bsr - full).abs().max().item(),
            bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
            bound_ms_every_slot=p3_bound_ms_every_slot(
                n, n, s_slots, used, l)[0],
            l2_sector_bytes=sector_bytes,
            l2_sector_bytes_per_ms=sector_bytes / ms)
        del xl, got, want, lib, full, bsr
    emit("ell", n=n, d=x.shape[1], k=EVAL_K, cap=cap, slots=s_slots,
         counted_slots=counted, used_slots=used,
         padding_share=1.0 - used / (n * s_slots),
         counted_share=counted / (n * s_slots), overflow_edges=ovf,
         ovf_cap=ovf_cap, per_l=per_l)
    del csr, mat, plan
    torch.cuda.empty_cache()

    runs = []
    p3.ell_gather_spmm.launches = 0
    for _ in range(5):
        before = p3.ell_gather_spmm.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred, iters, err = transductive_laplace(
            x, y, knn_num=EVAL_K, tau=EVAL_TAU, mode="ell", return_info=True)
        torch.cuda.synchronize()
        runs.append(dict(s=time.perf_counter() - t0, cg_iters=iters,
                         cg_err=float(err),
                         p3_launches=p3.ell_gather_spmm.launches - before))
    launches = p3.ell_gather_spmm.launches
    agree = (pred.argmax(1) == bsr_pred.argmax(1)).float().mean().item()
    s_per_solve = statistics.mean(r["s"] for r in runs[2:])
    emit("ell_solve", n=n, k=EVAL_K, tau=EVAL_TAU, warmups=2, runs=runs,
         s_per_solve=s_per_solve, argmax_agreement_bsr=agree,
         bsr_cg_iters=bsr_iters, bsr_cg_err=float(bsr_err),
         p3_launches=launches)
    check(all(r["cg_err"] <= 1e-10 for r in runs),
          f"the ELL solve converged ({runs})")
    check(agree >= 0.999, f"ELL and BSR solves agree on {agree} >= 0.999 "
          f"of the argmax")
    check(all(r["p3_launches"] == r["cg_iters"] + 2 for r in runs),
          "P3 launched CG iterations + 2 times a solve")
    return dict(per_l=per_l, launches=launches, slots=s_slots,
                used_slots=used, counted_slots=counted)


def probe_inputs():
    """The probes phase's inputs on the card, from SEED: P1's blocks at
    P1_SHAPES, the gated scale's block and an array of P1_SCALE_LARGE
    elements, each with a positive max and without one, and P2's (x, idx)
    at each of P2_CASES."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    blocks = {(q, m): torch.randn((q, m), generator=gen, device="cuda")
              for q, m in P1_SHAPES}
    signs = {"positive": blocks[P1_SHAPES[0]],
             "negative": -blocks[P1_SHAPES[0]].abs()}
    large = torch.randn(P1_SCALE_LARGE, generator=gen, device="cuda")
    signs[f"positive_{P1_SCALE_LARGE}"] = large
    signs[f"negative_{P1_SCALE_LARGE}"] = -large.abs()
    gathers = {}
    for m, n, axis in P2_CASES:
        gathers[(m, n, axis)] = (
            torch.randn((m, n), generator=gen, device="cuda"),
            torch.randint(0, m if axis == 0 else n, (m, n), generator=gen,
                          device="cuda"))
    return blocks, signs, gathers


def launch_floor_ms() -> float:
    """Device ms of a kernel that returns at once (the spin kernel with
    zero cycles) by device_ms: the part of a short kernel's time that no
    design of it can take away."""
    import torch

    return device_ms(lambda: torch.cuda._sleep(0))


def p2_sector_bytes(idx, n: int) -> int:
    """Bytes of the 32-byte L2 sectors that P2's axis-0 gathers of x
    (m, n) float32 fetch, counting a sector once for each row of out that
    reads it (a row's gathers are one warp's requests; the sector's other
    uses by other rows count again)."""
    import torch

    col = torch.arange(n, device=idx.device)
    sectors = torch.sort((idx * n + col) // 8, dim=1).values
    distinct = sectors.shape[0] + (sectors.diff(dim=1) != 0).sum().item()
    return 32 * int(distinct)


def p1_p2_bound_ms(nbytes: int) -> float:
    """P1's and P2's bound: bytes over the card's rate (they do no
    arithmetic worth counting)."""
    return 1e3 * nbytes / PEAK_BYTES_PER_S


def phase_probes() -> dict:
    """P1 and P2, the counterparts of the TPU probes, which no path calls.
    The probe run: P1's sort ascending and descending (the probe's sort and
    full lax.top_k) at each of P1_SHAPES and its gated scale on a block
    with a positive max and on one without (its one-cluster path), and on
    P1_SCALE_LARGE elements each way (its two-kernel path), P2 at each of
    P2_CASES, each
    once, with the counts set to 0 before and read after.  Then each
    output equal to its plain version's on the same input, and device ms
    (100 back-to-back launches) beside the plain version's, one library
    call's (torch.topk over the whole row, whose order among equal values
    is open; torch.take_along_dim; none computes the gated scale in one
    call), the bound and the launch floor; P2's L2 sectors at axis 0."""
    import torch

    from graphlearninglayer_tpu_torch.ops.kernels import row_sort as p1
    from graphlearninglayer_tpu_torch.ops.kernels import take_along as p2

    blocks, signs, gathers = probe_inputs()
    p1.row_sort.launches = p1.scale_if_max_positive.launches = 0
    p2.take_along.launches = 0
    sorted_out = {(shape, desc): p1.row_sort(x, desc)
                  for shape, x in blocks.items() for desc in (False, True)}
    scaled = {name: p1.scale_if_max_positive(x) for name, x in signs.items()}
    taken = {case: p2.take_along(x, idx, case[2])
             for case, (x, idx) in gathers.items()}
    torch.cuda.synchronize()
    launches = dict(row_sort=p1.row_sort.launches,
                    scale_if_max_positive=p1.scale_if_max_positive.launches,
                    take_along=p2.take_along.launches)
    check(launches == dict(row_sort=2 * len(P1_SHAPES),
                           scale_if_max_positive=len(signs),
                           take_along=len(P2_CASES)),
          f"each probe case launched its kernel once ({launches})")
    floor_ms = launch_floor_ms()

    sorts = {}
    for (shape, desc), (vals, idx) in sorted_out.items():
        x = blocks[shape]
        pv, pi = p1.row_sort_plain(x, desc)
        check(torch.equal(vals, pv) and torch.equal(idx, pi),
              f"P1 row sort equals torch.sort(stable) at {shape}, "
              f"descending={desc}")
        q, m = shape
        sorts[f"{q}x{m}{'_desc' if desc else ''}"] = dict(
            max_abs_err=(vals - pv).abs().max().item(),
            ms=device_ms(lambda: p1.row_sort(x, desc)),
            plain_ms=device_ms(lambda: p1.row_sort_plain(x, desc)),
            library_ms=device_ms(lambda: torch.topk(x, m, dim=1,
                                                    largest=not desc)),
            bound_ms=p1_p2_bound_ms(16 * q * m), bound_by="bytes",
            launch_floor_ms=floor_ms)
    gated = {}
    for name, out in scaled.items():
        x = signs[name]
        check(torch.equal(out, p1.scale_if_max_positive_plain(x)),
              f"P1 gated scale equals plain ({name} max)")
        gated[name] = dict(
            ms=device_ms(lambda: p1.scale_if_max_positive(x)),
            plain_ms=device_ms(lambda: p1.scale_if_max_positive_plain(x)),
            library_ms=None,
            bound_ms=p1_p2_bound_ms(8 * x.numel()), bound_by="bytes",
            launch_floor_ms=floor_ms)
    takes = {}
    for case, out in taken.items():
        (x, idx), (m, n, axis) = gathers[case], case
        want = p2.take_along_plain(x, idx, axis)
        check(torch.equal(out, want), f"P2 equals torch.gather at {case}")
        ms = device_ms(lambda: p2.take_along(x, idx, axis))
        takes[f"{m}x{n}_axis{axis}"] = dict(
            max_abs_err=(out - want).abs().max().item(), ms=ms,
            plain_ms=device_ms(lambda: p2.take_along_plain(x, idx, axis)),
            library_ms=device_ms(lambda: torch.take_along_dim(x, idx, axis)),
            bound_ms=p1_p2_bound_ms(16 * m * n), bound_by="bytes",
            launch_floor_ms=floor_ms)
        if axis == 0:
            sector_bytes = p2_sector_bytes(idx, n)
            takes[f"{m}x{n}_axis{axis}"].update(
                l2_sector_bytes=sector_bytes,
                l2_sector_bytes_per_ms=sector_bytes / ms)
    emit("probes", launches=launches, row_sort=sorts,
         scale_if_max_positive=gated, take_along=takes,
         library="torch.topk over the whole row (P1); "
                 "torch.take_along_dim (P2)")
    return dict(launches=launches,
                max_abs_err=dict(
                    row_sort=max(v["max_abs_err"] for v in sorts.values()),
                    take_along=max(v["max_abs_err"]
                                   for v in takes.values())),
                row_sort=sorts, scale=gated, take_along=takes)


def phase_transductive_eval(state):
    """The eval main path; returns K2's launches in it."""
    import numpy as np
    import torch

    from graphlearninglayer_tpu_torch.data import (CHANNEL_STATS,
                                                   synthetic_dataset)
    from graphlearninglayer_tpu_torch.evalx import test_gl_transductive
    from graphlearninglayer_tpu_torch.ops import EvalGraphCache
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2
    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2

    t0 = time.perf_counter()
    spec = synthetic_dataset(num_classes=NUM_CLASSES, image_shape=(32, 32, 3),
                             n_train=EVAL_TRAIN, n_test=EVAL_TEST,
                             seed=SEED + 3)
    data_s = time.perf_counter() - t0
    base = np.random.default_rng(SEED + 3).permutation(EVAL_TRAIN)[:EVAL_BASE]
    # PyTorch's default for convolutions, as a user's eval would run
    torch.backends.cudnn.allow_tf32 = True
    cache, stats = EvalGraphCache(), {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.fused_affinity_sym.launches = 0
    k2.fused_knn.launches = 0
    acc = test_gl_transductive(
        state, spec.train_images[base], spec.train_labels[base],
        spec.test_images, spec.test_labels, None, NUM_CLASSES,
        train_images=spec.train_images, knn_num=EVAL_K, tau=EVAL_TAU,
        norm=CHANNEL_STATS["cifar10"], cache=cache, device="cuda",
        stats=stats)
    launches = k2.fused_knn.launches
    k1_launches = k1.fused_affinity_sym.launches
    emit("transductive_eval", base=EVAL_BASE, train=EVAL_TRAIN,
         test=EVAL_TEST, k=EVAL_K, tau=EVAL_TAU, cudnn_tf32=True,
         matmul_tf32=False, acc=acc, chance=100.0 / NUM_CLASSES,
         dataset_s=data_s, mode="bsr" if cache.perm is not None else "sorted",
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         k2_launches=launches, k1_launches=k1_launches, **stats)
    check(launches >= 1, f"K2 launched in the eval ({launches})")
    check(stats["n_nodes"] == EVAL_N, "eval graph size")
    check(acc > 100.0 / NUM_CLASSES, f"eval accuracy {acc} above chance")
    return launches


def phase_k3():
    """K3 against its plain version; returns its stats at n=1500 and the
    launches of the phase's checked calls.

    The mask is the port's KNN indicator (k=25) without self loops, as the
    graph uses it (the JAX kernel test takes the final graph mask, which
    has none).  On the diagonal d2 = |x|^2 + |x|^2 - 2 x.x is pure float32
    cancellation, and W = exp(-4 d2 / eps^2) ~ 1 there turns the two
    versions' different summation orders into differences above 1e-6; the
    error with the self loops kept is reported beside, not held to 1e-6."""
    import torch

    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k3

    result, errs = {}, []
    k3.fused_affinity.launches = 0
    for n, eps_mode in ((1500, "auto"), (300, "auto"), (1500, "fixed")):
        args = k3_inputs(n, eps_mode)
        x, mask = args[0], args[2]
        got = k3.fused_affinity(*args)
        want = k3.fused_affinity_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs.append(err)
        check(err <= K3_TOL, f"K3 max |kernel - plain| {err} <= {K3_TOL} "
              f"at n={n}, eps {eps_mode}")
        check(int((got > 0).sum()) == n * (K - 1), "K3 keeps every edge")
        launches = k3.fused_affinity.launches
        with_self = mask.clone().fill_diagonal_(1.0)
        err_self = (k3.fused_affinity(x, args[1], with_self)
                    - k3.fused_affinity_plain(x, args[1], with_self)
                    ).abs().max().item()
        times = affinity_times(lambda: k3.fused_affinity(*args),
                               lambda: k3.fused_affinity_plain(*args), n)
        k3.fused_affinity.launches = launches   # only checked calls count
        emit("k3", n=n, d=128, k=K, eps=eps_mode, max_abs_err=err,
             tol=K3_TOL, max_abs_err_with_self_loops=err_self, **times,
             library_ms=None,
             library="none: no single PyTorch call computes it")
        if n == 1500 and eps_mode == "auto":
            result = dict(times)
    result["max_abs_err"] = max(errs)
    result["launches"] = k3.fused_affinity.launches
    check(result["launches"] == 3, "K3 launched once per checked call")
    return result


def phase_op_edge():
    """laplace_learning(mode='edge') with both solvers on the card, against
    the port's float64 CPU result and against dense mode on the card."""
    import torch

    from graphlearninglayer_tpu_torch.ops import laplace_learning

    n, k_lab, l = N_BASE + N_BATCH, N_BASE, NUM_CLASSES
    x, seed = normalized_features(n, 128, SEED, min_gap=2e-6)
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, l, (k_lab,), generator=gen)
    y = torch.nn.functional.one_hot(labels, l).double()
    gbar = torch.randn(n - k_lab, l, generator=gen, dtype=torch.float64)

    def run(xv, yv, gv, **kw):
        xv = xv.clone().requires_grad_(True)
        stats = {}
        pred = laplace_learning(xv, yv, tau=TAU, epsilon="auto", k=K,
                                stats=stats, **kw)
        (pred * gv).sum().backward()
        return pred.detach(), xv.grad, stats

    dev = torch.device("cuda")
    xc, yc, gc = x.to(dev), y.float().to(dev), gbar.float().to(dev)
    dense, dense_gx, _ = run(xc, yc, gc, mode="dense")
    for solver in ("cholesky", "cg"):
        want, want_gx, _ = run(x.double(), y, gbar, mode="edge",
                               solver=solver)
        pred, gx, stats = run(xc, yc, gc, mode="edge", solver=solver)
        torch.cuda.synchronize()
        scale = want_gx.abs().max()
        pred_err = (pred.double().cpu() - want).abs().max().item()
        gx_rel = ((gx.double().cpu() - want_gx).abs().max() / scale).item()
        dense_err = (pred - dense).abs().max().item()
        dense_rel = ((gx - dense_gx).abs().max().double().cpu()
                     / scale).item()
        ms = cuda_ms(lambda: run(xc, yc, gc, mode="edge", solver=solver),
                     reps=5 if solver == "cg" else 20, warmup=1)
        emit("op_edge", solver=solver, n=n, k_lab=k_lab, l=l, d=128, k=K,
             tau=TAU, input_seed=seed, pred_max_abs_err=pred_err,
             pred_tol=1e-4, grad_max_rel_err=gx_rel, grad_tol=1e-3,
             vs_dense_pred_err=dense_err, vs_dense_grad_rel_err=dense_rel,
             cg_iters=stats.get("cg_iters"),
             cg_iters_bwd=stats.get("cg_iters_bwd"),
             chol_info=int(stats["chol_info"]) if "chol_info" in stats
             else None, fwd_bwd_ms=ms)
        check(pred_err <= 1e-4, f"edge {solver} pred err {pred_err} <= 1e-4")
        check(gx_rel <= 1e-3, f"edge {solver} grad rel err {gx_rel} <= 1e-3")
        check(dense_err <= 1e-4 and dense_rel <= 1e-3,
              f"edge {solver} agrees with dense mode ({dense_err}, "
              f"{dense_rel})")


def _trace_busy_share(trace_dir: str) -> dict:
    """Device busy share over the traced epoch, from the Chrome trace that
    the driver's GLL_PROFILE_DIR hook wrote: the union of kernel, memcpy
    and memset spans over the span of all traced events."""
    import glob
    import os

    files = sorted(glob.glob(os.path.join(trace_dir, "*.json")))
    check(len(files) == 1, f"one trace file in {trace_dir} ({files})")
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    check(bool(dev), "the trace holds device activity")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy = _union(dev)
    return dict(trace_mb=os.path.getsize(files[0]) / 2**20,
                window_ms=(t1 - t0) / 1e3, device_busy_ms=busy / 1e3,
                busy_share=busy / (t1 - t0), device_spans=len(dev))


def phase_fullysup(train_tf32_ms: float) -> dict:
    """The driver's main path and three short runs; returns K1's and K2's
    launches in the main run.  Every eval must converge (residual
    <= 1e-10) with its accuracy above chance."""
    import os
    import shutil
    import tempfile

    import torch

    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2
    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2
    from graphlearninglayer_tpu_torch.train import fullysup

    torch.backends.cudnn.allow_tf32 = True    # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    home = os.getcwd()
    work = tempfile.mkdtemp(prefix="gll_fullysup_")
    os.environ["GLL_PROFILE_DIR"] = os.path.join(work, "trace")
    os.environ["GLL_PROFILE_EPOCH"] = str(DRIVER_EPOCHS)
    try:
        os.chdir(work)
        t0 = time.perf_counter()
        k1.fused_affinity_sym.launches = 0
        k2.fused_knn.launches = 0
        rec = fullysup.main(DRIVER_ARGV + [
            "--synth_n_train", str(DRIVER_TRAIN),
            "--synth_n_test", str(DRIVER_TEST),
            "--epochs", str(DRIVER_EPOCHS)])
        k1_launches = k1.fused_affinity_sym.launches
        k2_launches = k2.fused_knn.launches
        wall = time.perf_counter() - t0
        del os.environ["GLL_PROFILE_DIR"]
        steps = rec["steps_per_epoch"]
        ms_per_step = [1e3 * s / steps for s in rec["epoch_s"]]
        trace = _trace_busy_share(os.path.join(work, "trace"))
        evals = [{k: e[k] for k in ("n_nodes", "cg_iters", "cg_err",
                                    "encode_s", "solve_s", "acc")}
                 for e in rec["eval"]]
        emit("fullysup", argv=DRIVER_ARGV, train=DRIVER_TRAIN,
             test=DRIVER_TEST, epochs=DRIVER_EPOCHS, steps_per_epoch=steps,
             loader_backend=rec["loader_backend"], cudnn_tf32=True,
             matmul_tf32=False, wall_s=wall,
             epoch_s=rec["epoch_s"], ms_per_step=ms_per_step,
             ms_per_step_note=("epoch 1 includes the first steps' warm-up; "
                               "epoch 2 runs under the profiler"),
             train_phase_tf32_ms_per_step=train_tf32_ms,
             host_share_epoch1=1 - train_tf32_ms / ms_per_step[0],
             traced_epoch=DRIVER_EPOCHS, trace=trace, evals=evals,
             test_acc=rec["test_acc"], loss=rec["loss"],
             train_acc=rec["train_acc"], chance=100.0 / NUM_CLASSES,
             k1_launches=k1_launches, k2_launches=k2_launches)
        check(rec["loader_backend"] == "native", "native augmentation")
        check(steps == DRIVER_TRAIN // N_BATCH, "40 steps an epoch")
        check(len(rec["loss"]) == DRIVER_EPOCHS
              and all(math.isfinite(v) for v in rec["loss"]),
              "finite loss every epoch")
        check(len(evals) == DRIVER_EPOCHS + 1
              and all(e["n_nodes"] == EVAL_N for e in evals),
              f"{DRIVER_EPOCHS + 1} evals of {EVAL_N} nodes")
        check(all(e["cg_err"] <= 1e-10 for e in evals),
              f"every eval's CG converged ({[e['cg_err'] for e in evals]})")
        check(k1_launches >= DRIVER_EPOCHS * steps,
              f"K1 launched on every GL step ({k1_launches})")
        check(k2_launches >= len(evals),
              f"K2 launched on every eval ({k2_launches})")
        check(all(a > 100.0 / NUM_CLASSES for a in rec["test_acc"]),
              f"every eval's accuracy above chance ({rec['test_acc']})")
        last = os.path.join(work, "save", "_Sup_and_SS_gl",
                            os.listdir(os.path.join(work, "save",
                                                    "_Sup_and_SS_gl"))[0],
                            "last")
        check(os.path.isfile(os.path.join(
            last, f"ckpt_epoch_{DRIVER_EPOCHS}.pth")), "last checkpoint")

        small = ["--synth_n_train", "5000", "--synth_n_test", "1000",
                 "--epochs", "1"]
        runs = {
            "resume": ["--cp_load_path", last, "--start_epochs",
                       str(DRIVER_EPOCHS), "--train_prefix", "resume"],
            "mlp": ["--sup_train_type", "mlp", "--train_prefix", "mlp"],
            "cg": ["--gl_solver", "cg", "--train_prefix", "cg"],
        }
        for name, extra in runs.items():
            t1 = time.perf_counter()
            # a flag given twice takes its last value
            r = fullysup.main(DRIVER_ARGV + small + extra)
            emit("fullysup_short", run=name, wall_s=time.perf_counter() - t1,
                 loss=r["loss"], test_acc=r["test_acc"],
                 cg_iters_per_step=r["cg_iters"],
                 ms_per_step=[1e3 * s / r["steps_per_epoch"]
                              for s in r["epoch_s"]])
            check(len(r["loss"]) == 1 and math.isfinite(r["loss"][0]),
                  f"{name}: one finite epoch")
            check(len(r["test_acc"]) == 2, f"{name}: two evals")
            if name == "cg":
                check(bool(r["cg_iters"]) and r["cg_iters"][0] > 0,
                      "cg: CG iterations recorded")
    finally:
        os.environ.pop("GLL_PROFILE_DIR", None)
        os.environ.pop("GLL_PROFILE_EPOCH", None)
        os.chdir(home)
        shutil.rmtree(work, ignore_errors=True)
    return dict(k1_launches=k1_launches, k2_launches=k2_launches,
                ms_per_step=ms_per_step)


def _adv_steps(dataset: str, target: str, rob_or_nat: str, synth: dict,
               profiled: int = 0) -> dict:
    """The adversarial driver's own training step (``make_train_step``)
    on a fresh state and one synthetic batch stream: a warm-up step, then
    ``ADV_TIMED_STEPS`` steps on the host clock, each ending in a sync,
    then ``profiled`` steps under torch.profiler.  Returns the timed
    steps' ms, K1's launches in each step, every op call's Cholesky info,
    the profile and, for robust GL, how far one more PGD call's output
    leaves the eps ball and the data range."""
    import numpy as np
    import torch

    from graphlearninglayer_tpu_torch.attack.pgd import make_gl_pgd_perturb_p
    from graphlearninglayer_tpu_torch.data import (Transform,
                                                   select_base_indices,
                                                   synthetic_dataset)
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2
    from graphlearninglayer_tpu_torch.train import adversarial_driver as ad
    from graphlearninglayer_tpu_torch.train import create_train_state

    cfg = ad.DATASET_CONFIGS[dataset]
    dev = torch.device("cuda")
    channels = 3 if dataset == "cifar10" else 1
    side = 32 if dataset == "cifar10" else 28
    spec = synthetic_dataset(NUM_CLASSES, (side, side, channels), seed=SEED,
                             **synth)
    x_all = ad._nchw(Transform(dataset).normalize(spec.train_images), dev)
    y_all = torch.as_tensor(spec.train_labels).long().to(dev)
    base_idx = select_base_indices(
        spec.train_labels, NUM_CLASSES * cfg.base_sample_rate, NUM_CLASSES,
        rng=np.random.default_rng(SEED))
    base = torch.as_tensor(base_idx).to(dev)
    rest = torch.as_tensor(np.setdiff1d(np.arange(len(spec.train_labels)),
                                        base_idx)).to(dev)
    net = cfg.network_gl if target == "gl" else cfg.network_mlp
    state = create_train_state(
        ad.build_network(net, NUM_CLASSES, channels,
                         torch.Generator().manual_seed(SEED)),
        ad._make_schedule(cfg, 20), device=dev, **ad._make_tx(cfg, target))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lo = torch.as_tensor(cfg.min_val, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(cfg.max_val, dtype=torch.float32, device=dev)
    bx, by = x_all[base], y_all[base]
    step = ad.make_train_step(target, rob_or_nat, cfg, NUM_CLASSES, bx, by,
                              gen, lo, hi, dev)
    counts, stats, step_ms = [], [], []
    batch_i = iter(range(100))

    def batch():
        sel = rest[(torch.arange(cfg.batch_size, device=dev)
                    + cfg.batch_size * next(batch_i)) % len(rest)]
        return x_all[sel], y_all[sel]

    def one_step():
        x, y = batch()
        before = k1.fused_affinity_sym.launches
        step(state, x, y, stats)
        counts.append(k1.fused_affinity_sym.launches - before)

    one_step()                                     # warm-up
    for _ in range(ADV_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    out = dict(step_ms=step_ms, k1_launches_per_step=counts)
    if profiled:
        out["prof"] = profile_window(one_step, profiled)
    out["chol_info"] = [int(s["chol_info"]) for s in stats
                        if "chol_info" in s]
    if target == "gl" and rob_or_nat == "robust":
        perturb = make_gl_pgd_perturb_p(
            ad._eval_features, NUM_CLASSES, tau=cfg.gl_tau, k=K,
            eps=cfg.pgd_epsilon, alpha=cfg.pgd_alpha,
            num_iters=cfg.pgd_iters, device=dev)
        x, y = batch()
        adv = perturb(state.model, bx, by, x, y, gen, lo, hi)
        out["eps_ball_excess"] = ((adv - x).abs().max()
                                  - cfg.pgd_epsilon).item()
        out["range_excess"] = max((lo - adv).clamp_min(0).amax().item(),
                                  (adv - hi).clamp_min(0).amax().item())
    return out


def phase_adversarial() -> dict:
    """The adversarial path through its entry points; returns K1's
    launches in its runs (each read with the count set to 0 just before)
    and K1's device times at the path's shapes."""
    import os
    import shutil
    import tempfile

    import torch

    from graphlearninglayer_tpu_torch.attack import driver as attack_driver
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2
    from graphlearninglayer_tpu_torch.train import adversarial_driver as ad

    torch.backends.cudnn.allow_tf32 = True    # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    cifar = dict(n_train=ADV_TRAIN, n_test=ADV_TEST)
    mnist = dict(n_train=ADV_MNIST_TRAIN, n_test=ADV_MNIST_TEST)
    cfg = ad.DATASET_CONFIGS["cifar10"]
    home, work = os.getcwd(), tempfile.mkdtemp(prefix="gll_adv_")
    out: dict = {}
    try:
        os.chdir(work)
        models = os.path.join(work, "models")
        # robust training of both heads: K1 6 times a GL step, once an
        # eval batch
        k1.fused_affinity_sym.launches = 0
        t0 = time.perf_counter()
        rob = ad.run("both", "robust", "cifar10", epochs=1, save_dir=models,
                     synth=cifar)
        robust_launches = k1.fused_affinity_sym.launches
        steps = rob["gl_steps_per_epoch"]
        eval_batches = ADV_TEST // cfg.batch_size
        emit("adversarial_train", config="cifar10", heads="both",
             mode="robust", train=ADV_TRAIN, test=ADV_TEST, epochs=1,
             steps_per_epoch=steps, wall_s=time.perf_counter() - t0,
             gl_epoch_s=rob["gl_epoch_s"], mlp_epoch_s=rob["mlp_epoch_s"],
             gl_loss=rob["gl_loss"], mlp_loss=rob["mlp_loss"],
             gl_acc=rob["gl_acc"], mlp_acc=rob["mlp_acc"],
             gl_chol_info=rob["gl_chol_info"], gl_eval_s=rob["gl_eval_s"],
             k1_launches=robust_launches,
             k1_launches_per_robust_step=(robust_launches - eval_batches)
             / steps)
        check(robust_launches == 6 * steps + eval_batches,
              f"K1 launched 6 times a robust GL step and once an eval batch "
              f"({robust_launches} for {steps} steps, {eval_batches} "
              f"batches)")
        check(rob["gl_chol_info"] == 0, "every Cholesky of the robust run "
              "(tau 0) succeeded")
        for key in ("gl_loss", "mlp_loss"):
            check(all(math.isfinite(v) for v in rob[key]), f"finite {key}")
        for key in ("gl_acc", "mlp_acc"):
            check(0.0 <= rob[key] <= 1.0, f"{key} a finite accuracy")

        k1.fused_affinity_sym.launches = 0
        nat = ad.run("gl", "natural", "cifar10", epochs=1, save_dir=models,
                     synth=cifar)
        natural_launches = k1.fused_affinity_sym.launches
        emit("adversarial_natural", config="cifar10", heads="gl",
             steps_per_epoch=nat["gl_steps_per_epoch"],
             gl_epoch_s=nat["gl_epoch_s"], gl_loss=nat["gl_loss"],
             gl_acc=nat["gl_acc"], gl_chol_info=nat["gl_chol_info"],
             k1_launches=natural_launches)
        check(nat["gl_chol_info"] == 0 and math.isfinite(nat["gl_loss"][0]),
              "natural run: Cholesky succeeded, finite loss")

        # the driver's step, timed step by step, and profiled
        robust = _adv_steps("cifar10", "gl", "robust", cifar,
                            profiled=ADV_PROFILE_STEPS)
        natural = _adv_steps("cifar10", "gl", "natural", cifar)
        mlp = _adv_steps("cifar10", "mlp", "robust", cifar)
        prof = robust["prof"]
        groups = prof["groups_ms_per_step"]
        encoder = sum(groups.get(g, 0.0) for g in ("conv", "conv_layout",
                                                   "batchnorm"))
        op = sum(groups.get(g, 0.0) for g in ("k1_affinity", "cholesky_solve",
                                              "topk_sort"))
        emit("adversarial_steps", config="cifar10",
             gl_ms_per_robust_step_median=statistics.median(
                 robust["step_ms"]),
             gl_ms_per_natural_step_median=statistics.median(
                 natural["step_ms"]),
             mlp_ms_per_robust_step_median=statistics.median(mlp["step_ms"]),
             gl_robust_step_ms=robust["step_ms"],
             gl_natural_step_ms=natural["step_ms"],
             mlp_robust_step_ms=mlp["step_ms"])
        emit("adversarial_profile", steps=ADV_PROFILE_STEPS,
             k1_launches_per_step=robust["k1_launches_per_step"],
             chol_info=robust["chol_info"],
             eps_ball_excess=robust["eps_ball_excess"],
             range_excess=robust["range_excess"],
             encoder_share=encoder / prof["kernel_ms_per_step"],
             op_share_k1_cholesky_topk=op / prof["kernel_ms_per_step"],
             k1_share=groups.get("k1_affinity", 0.0)
             / prof["kernel_ms_per_step"], **prof)
        n_steps = 1 + ADV_TIMED_STEPS + ADV_PROFILE_STEPS
        check(robust["k1_launches_per_step"] == [6] * n_steps,
              f"K1 launched exactly 6 times a robust step "
              f"({robust['k1_launches_per_step']})")
        check(natural["k1_launches_per_step"] == [1] * (1 + ADV_TIMED_STEPS)
              and mlp["k1_launches_per_step"] == [0] * (1 + ADV_TIMED_STEPS),
              "K1 once a natural GL step, never in an MLP step")
        check(all(i == 0 for i in robust["chol_info"] + natural["chol_info"]),
              "every timed and profiled Cholesky succeeded")
        check(robust["eps_ball_excess"] <= 1e-6
              and robust["range_excess"] == 0.0,
              "PGD stays in the eps ball and the data range "
              f"({robust['eps_ball_excess']}, {robust['range_excess']})")

        sweeps = {}
        for attack, points, per_batch, rate in (
                ("ifgsm", ADV_SWEEP,
                 sum(int(5 * (p / 0.05)) + 1 for p in ADV_SWEEP),
                 attack_driver.FGSM_BASE_RATE["cifar10"]),
                ("cw", ADV_C, len(ADV_C) * (ADV_CW_ITERS + 2),
                 attack_driver.CW_BASE_RATE["cifar10"])):
            k1.fused_affinity_sym.launches = 0
            res = attack_driver.run(attack, "both", "robust", "cifar10",
                                    ckpt_dir=models, sweep=points,
                                    cw_iters=ADV_CW_ITERS, synth=cifar)
            launches = k1.fused_affinity_sym.launches
            sweeps[attack] = launches
            emit("adversarial_attack", attack=attack, config="cifar10",
                 base=NUM_CLASSES * rate, batch=cfg.batch_size,
                 nodes=NUM_CLASSES * rate + cfg.batch_size,
                 cw_iters=ADV_CW_ITERS if attack == "cw" else None,
                 cw_iters_reference=100 if attack == "cw" else None,
                 gl=res["gl"], mlp=res["mlp"], k1_launches=launches)
            batches = ADV_TEST // cfg.batch_size
            check(launches == per_batch * batches,
                  f"{attack}: K1 once an op call ({launches})")
            for p in res["gl"] + res["mlp"]:
                check(0.0 <= p["accuracy"] <= 1.0, f"{attack} accuracy")
            check(all(p["chol_info"] == 0 for p in res["gl"]),
                  f"{attack}: every Cholesky succeeded")

        k1.fused_affinity_sym.launches = 0
        mn = ad.run("gl", "natural", "mnist", epochs=1, save_dir=models,
                    synth=mnist)
        mnist_launches = k1.fused_affinity_sym.launches
        k1.fused_affinity_sym.launches = 0
        fg = attack_driver.run("fgsm", "gl", "natural", "mnist",
                               ckpt_dir=models, sweep=[0.1], synth=mnist)
        fgsm_launches = k1.fused_affinity_sym.launches
        mnist_steps = _adv_steps("mnist", "gl", "natural", mnist)
        mcfg = ad.DATASET_CONFIGS["mnist"]
        point = fg["gl"][0]
        emit("adversarial_mnist", train=ADV_MNIST_TRAIN, test=ADV_MNIST_TEST,
             train_nodes=10 * mcfg.base_sample_rate + mcfg.batch_size,
             steps_per_epoch=mn["gl_steps_per_epoch"],
             gl_epoch_s=mn["gl_epoch_s"],
             gl_ms_per_natural_step_median=statistics.median(
                 mnist_steps["step_ms"]),
             gl_natural_step_ms=mnist_steps["step_ms"],
             gl_loss=mn["gl_loss"], gl_acc=mn["gl_acc"],
             gl_chol_info=mn["gl_chol_info"], train_k1_launches=mnist_launches,
             fgsm_nodes=10 * attack_driver.FGSM_BASE_RATE["mnist"]
             + mcfg.batch_size, fgsm=fg["gl"],
             fgsm_k1_launches=fgsm_launches)
        check(mnist_launches == mn["gl_steps_per_epoch"] + 1,
              f"mnist: K1 once a step and an eval batch ({mnist_launches})")
        check(mn["gl_chol_info"] == 0 and math.isfinite(mn["gl_loss"][0])
              and all(i == 0 for i in mnist_steps["chol_info"]),
              "mnist: Cholesky succeeded, finite loss")
        check(fgsm_launches == 0 and point["op_calls"] == 2,
              "the 11,000-node FGSM: 2 op calls, in edge mode")
        check(point["chol_info"] == 0,
              f"the 11,000-node FGSM (tau 0): every Cholesky succeeded "
              f"(info {point['chol_info']})")
        check(0.0 <= point["accuracy"] <= 1.0, "the 11,000-node FGSM: an "
              "accuracy")
        out["launches"] = dict(robust=robust_launches,
                               natural=natural_launches,
                               ifgsm=sweeps["ifgsm"], cw=sweeps["cw"],
                               mnist=mnist_launches, mnist_fgsm=fgsm_launches)
    finally:
        os.chdir(home)
        shutil.rmtree(work, ignore_errors=True)

    shapes = []
    for n, d in ((300, 128), (700, 128), (1100, 200)):
        args = k1_inputs(n, d)
        err = (k1.fused_affinity_sym(*args)
               - k1.fused_affinity_sym_plain(*args)).abs().max().item()
        ms = device_ms(lambda: k1.fused_affinity_sym(*args))
        bound_ms, bound_by = k1_bound_ms(n, d)
        shapes.append(dict(n=n, d=d, ms=ms, bound_ms=bound_ms,
                           bound_by=bound_by, bound_share=bound_ms / ms,
                           max_abs_err=err))
        check(err <= K1_TOL, f"K1 at n={n}, d={d}: {err} <= {K1_TOL}")
    emit("adversarial_k1", shapes=shapes)
    out["k1_shapes"] = shapes
    return out


def _source_coords(h: int, w: int, coeffs, qx, qy):
    """float64 source coordinates (sx, sy) of an affine map at integer
    positions (qx, qy): the values whose floor picks the source pixel."""
    a, b, c0, d, e, f0 = (float(c) for c in coeffs)
    xc, yc = qx + 0.5, qy + 0.5
    return a * xc + b * yc + c0, d * xc + e * yc + f0


def _boundary_distance(sx, sy, pixels) -> float:
    """The largest, over the differing output pixels, of the distance of
    their source coordinates to the nearest integer (where a rounding
    difference can move the floor)."""
    rows, cols = pixels[:, 0], pixels[:, 1]
    dist = [min(abs(x - round(x)), abs(y - round(y)))
            for x, y in zip(sx[rows, cols], sy[rows, cols])]
    return max(dist)


def _geo_coords(h: int, w: int, op: int, sv: float):
    """Source coordinates of a geometric RandAugment op at signed
    magnitude ``sv`` over the whole image, or None for a pixel op."""
    import numpy as np
    import torch

    from graphlearninglayer_tpu_torch.data import device_aug as da

    table = {9: (1, sv, 0, 0, 1, 0), 10: (1, 0, 0, sv, 1, 0),
             12: (1, 0, sv * w, 0, 1, 0), 13: (1, 0, 0, 0, 1, sv * h)}
    if op == 7:
        coeffs = da._rotate_coeffs(h, w, torch.tensor([sv],
                                                      dtype=torch.float64))
    elif op in table:
        coeffs = table[op]
    else:
        return None
    qy, qx = np.mgrid[0:h, 0:w].astype(np.float64)
    return _source_coords(h, w, coeffs, qx, qy)


def _compare_images(got, ref, coords, what: str, against: str,
                    differing: list) -> None:
    """Record the output pixels where ``got`` and ``ref`` (H, W, C uint8)
    differ, with their source coordinates' distance to the integer
    boundary; fail unless every such pixel lies within 1e-9 of it (a
    rounding tie of the float64 coordinate)."""
    import numpy as np

    pixels = np.argwhere((got != ref).any(-1))
    if not len(pixels):
        return
    dist = (_boundary_distance(*coords, pixels) if coords is not None
            else None)
    differing.append(dict(case=what, against=against, pixels=len(pixels),
                          boundary_distance=dist))
    check(dist is not None and dist <= 1e-9,
          f"device aug {what}: {len(pixels)} pixels differ from {against} "
          f"away from an integer boundary ({dist})")


def phase_device_aug() -> dict:
    """The card's augmentation against the port on the CPU and the native
    backend, per op and for the prefix warp and the cutout at fixed
    parameters, the batch transforms on the card, and the card's time for
    one step's images beside the native backend's."""
    import os

    import numpy as np
    import torch

    from graphlearninglayer_tpu_torch.data import device_aug as da
    from graphlearninglayer_tpu_torch.data import native

    check(native.native_available(), "the native augmentation backend")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rgb = rng.integers(0, 256, (32, 32, 3), np.uint8)
    rgb[..., 1] = 40 + rgb[..., 1] % 150        # a limited-range channel
    gray = rng.integers(0, 256, (28, 28, 1), np.uint8)
    differing: list = []
    cases = 0
    for img in (rgb, gray):
        h, w, c = img.shape
        on_card = torch.from_numpy(img).to(dev)
        for name, op in da.OP_IDS.items():
            lo, hi = float(da._OP_LO[op]), float(da._OP_HI[op])
            for frac in (0.0, 0.33, 0.77, 1.0):
                for sign in (False, True):
                    v = lo + frac * (hi - lo)
                    got = da.device_apply_op(on_card, op, v, sign)
                    got = got.cpu().numpy()
                    what = f"{name} v={v:.4f} sign={sign} c={c}"
                    coords = _geo_coords(h, w, op, -v if sign else v)
                    _compare_images(got, da.device_apply_op(img, op, v,
                                                            sign).numpy(),
                                    coords, what, "cpu", differing)
                    _compare_images(got, native.apply_op_native(img, op, v,
                                                                sign),
                                    coords, what, "native", differing)
                    cases += 1
        # the prefix warp (rotate -> flip -> pad+crop as one resample) and
        # the cutout at fixed parameters
        ang, pad, (i, j) = 13.7, 4, (1, 6)
        reflect = c == 3
        cfg = dict(rotation=20, flip=True, pad=pad, pad_reflect=reflect)
        params = [torch.tensor([ang], dtype=torch.float64),
                  torch.tensor([True]), torch.tensor([[i, j]])]
        out = {}
        for where in ("cuda", "cpu"):
            src, valid = da._prefix_src(h, w, 1, *(p.to(where)
                                                   for p in params),
                                        device=where, **cfg)
            x = da._to_planar(torch.from_numpy(img)[None].to(where))
            out[where] = da._from_planar(da._warp(x, src, valid), h,
                                         w)[0].cpu().numpy()
        nat = native.pad_crop_native(native.mirror_native(
            native.rotate_native(img, ang)), pad, reflect, i, j)
        # source coordinates: crop, reflect or zero box, flip, rotation
        qy, qx = np.mgrid[0:h, 0:w] + np.array([i - pad, j - pad])[:, None,
                                                                    None]
        if reflect:
            qy, qx = np.abs(qy), np.abs(qx)
            qy = np.where(qy >= h, 2 * h - 2 - qy, qy)
            qx = np.where(qx >= w, 2 * w - 2 - qx, qx)
        qx = w - 1 - np.clip(qx, 0, w - 1)
        coords = _source_coords(h, w, da._rotate_coeffs(h, w, params[0]),
                                qx.astype(np.float64),
                                np.clip(qy, 0, h - 1).astype(np.float64))
        what = f"prefix c={c}"
        _compare_images(out["cuda"], out["cpu"], coords, what, "cpu",
                        differing)
        _compare_images(out["cuda"], nat, coords, what, "native", differing)
        for frac, r1, r2 in ((0.4, 0.3, 0.6), (0.49, 0.99, 0.01)):
            got = da.device_cutout(torch.from_numpy(img).to(dev), frac, r1,
                                   r2).cpu().numpy()
            what = f"cutout {frac} {r1} {r2} c={c}"
            _compare_images(got, da.device_cutout(img, frac, r1,
                                                  r2).numpy(),
                            None, what, "cpu", differing)
            _compare_images(got, native.cutout_native(img, frac, r1, r2),
                            None, what, "native", differing)
        cases += 3

    transforms = []
    for dataset, mode in (("cifar10", "weak"), ("cifar10", "strong"),
                          ("mnist", "strong")):
        shape = (32, 32, 3) if dataset == "cifar10" else (28, 28, 1)
        batch = torch.from_numpy(rng.integers(0, 256, (AUG_BATCH, *shape),
                                              np.uint8)).to(dev)
        tf = da.DeviceTransform(dataset, mode)
        gen = torch.Generator(device=dev)
        params = tf.draw(AUG_BATCH, gen.manual_seed(1), dev)
        out = tf.apply(batch, params)
        check(torch.equal(out, tf(batch, gen.manual_seed(1))),
              f"{dataset} {mode}: a seeded generator repeats its draws")
        # the card against the CPU at the same draws, on the first rows
        sub = {k: v[:AUG_PARITY_ROWS].cpu() for k, v in params.items()
               if isinstance(v, torch.Tensor)}
        sub["rounds"] = [tuple(t[:AUG_PARITY_ROWS].cpu() for t in r)
                         for r in params["rounds"]]
        sub["cutout"] = tuple(t[:AUG_PARITY_ROWS].cpu()
                              for t in params["cutout"])
        cpu = tf.apply(batch[:AUG_PARITY_ROWS].cpu(), sub)
        rows_differ = int((out[:AUG_PARITY_ROWS].cpu() != cpu)
                          .flatten(1).any(1).sum())
        transforms.append(dict(dataset=dataset, mode=mode, shape=shape,
                               rows=AUG_BATCH, parity_rows=AUG_PARITY_ROWS,
                               rows_differing_from_cpu=rows_differ,
                               changed_share=float((out != batch).float()
                                                   .mean())))
        check(out.dtype == torch.uint8 and out.shape == batch.shape,
              f"{dataset} {mode}: uint8 of the batch's shape")
        check(rows_differ == 0, f"{dataset} {mode}: card equals CPU on "
              f"{AUG_PARITY_ROWS} rows at the same draws ({rows_differ})")

    # one step's images (250 + 1250) in strong mode: the card against the
    # host's native backend on all its cores
    tf = da.DeviceTransform("cifar10", "strong")
    batch_np = rng.integers(0, 256, (AUG_BATCH, 32, 32, 3), np.uint8)
    batch = torch.from_numpy(batch_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    card_ms = cuda_ms(lambda: tf(batch, gen), reps=10, warmup=2)
    seeds = rng.integers(0, 2**63, AUG_BATCH, dtype=np.uint64)
    host = []
    for _ in range(6):
        t0 = time.perf_counter()
        native.augment_batch_native(batch_np, seeds, rand_n=2, rotation=0,
                                    flip=True, pad=4, pad_reflect=True)
        host.append(1e3 * (time.perf_counter() - t0))
    result = dict(op_cases=cases, differing=differing,
                  transforms=transforms, timed_rows=AUG_BATCH,
                  card_strong_ms=card_ms,
                  native_strong_ms=statistics.median(host[1:]),
                  native_threads=os.cpu_count())
    emit("device_aug", **result)
    return result


def _trace_h2d(trace_dir: str) -> dict:
    """Host-to-device copies in the traced epoch's Chrome trace: their
    count and bytes (the trace's ``bytes`` argument of each memcpy)."""
    import glob
    import os

    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    return dict(h2d_copies=len(copies),
                h2d_bytes=sum(int(e.get("args", {}).get("bytes", 0))
                              for e in copies),
                h2d_bytes_known=all("bytes" in e.get("args", {})
                                    for e in copies))


def phase_device_data(train_tf32_ms: float, host: dict) -> dict:
    """The driver with ``--device_data``: the fullysup phase's run with the
    splits resident on the card and the augmentation there; returns K1's
    and K2's launches, the work directory and its last checkpoint."""
    import os
    import tempfile

    import numpy as np
    import torch

    from graphlearninglayer_tpu_torch.data import CHANNEL_STATS
    from graphlearninglayer_tpu_torch.evalx import (encode_dataset,
                                                    encode_dataset_resident)
    from graphlearninglayer_tpu_torch.models import BuildNet
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2
    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2
    from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                    fullysup,
                                                    make_encode_step,
                                                    make_lr_schedule)
    from graphlearninglayer_tpu_torch.utils.checkpoint import \
        restore_checkpoint

    torch.backends.cudnn.allow_tf32 = True    # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    home = os.getcwd()
    work = tempfile.mkdtemp(prefix="gll_device_data_")
    trace_dir = os.path.join(work, "trace")
    os.environ["GLL_PROFILE_DIR"] = trace_dir
    os.environ["GLL_PROFILE_EPOCH"] = str(DRIVER_EPOCHS)
    try:
        os.chdir(work)
        t0 = time.perf_counter()
        k1.fused_affinity_sym.launches = 0
        k2.fused_knn.launches = 0
        rec = fullysup.main(DRIVER_ARGV + [
            "--device_data", "--synth_n_train", str(DRIVER_TRAIN),
            "--synth_n_test", str(DRIVER_TEST),
            "--epochs", str(DRIVER_EPOCHS)])
        k1_launches = k1.fused_affinity_sym.launches
        k2_launches = k2.fused_knn.launches
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("GLL_PROFILE_DIR", None)
        os.environ.pop("GLL_PROFILE_EPOCH", None)
        os.chdir(home)
    steps = rec["steps_per_epoch"]
    ms_per_step = [1e3 * s / steps for s in rec["epoch_s"]]
    trace = _trace_busy_share(trace_dir)
    h2d = _trace_h2d(trace_dir)
    evals = [{k: e[k] for k in ("n_nodes", "cg_iters", "cg_err", "encode_s",
                                "solve_s", "acc")} for e in rec["eval"]]
    save = os.path.join(work, "save", "_Sup_and_SS_gl")
    last = os.path.join(save, os.listdir(save)[0], "last")

    # the resident encode of the run's last state against the streaming
    # encode, on random images (a ragged last batch of 904 rows)
    model = BuildNet("resnet18", num_classes=NUM_CLASSES)
    state, _ = restore_checkpoint(last, create_train_state(
        model, make_lr_schedule(0.01, 1, 1)))
    images = np.random.default_rng(SEED + 5).integers(
        0, 256, (DD_CHECK_ROWS, 32, 32, 3), np.uint8)
    norm = CHANNEL_STATS["cifar10"]
    stream = encode_dataset(make_encode_step(norm=norm), state, images)
    resident = encode_dataset_resident(
        state, torch.from_numpy(images.reshape(DD_CHECK_ROWS, -1)).cuda(),
        DD_CHECK_ROWS, (32, 32, 3), norm)
    bitwise = bool(torch.equal(stream, resident))

    emit("device_data", argv=DRIVER_ARGV + ["--device_data"],
         train=DRIVER_TRAIN, test=DRIVER_TEST, epochs=DRIVER_EPOCHS,
         steps_per_epoch=steps, loader_backend=rec["loader_backend"],
         cudnn_tf32=True, matmul_tf32=False, wall_s=wall,
         epoch_s=rec["epoch_s"], ms_per_step=ms_per_step,
         ms_per_step_note=("epoch 1 includes the first steps' warm-up; "
                           "epoch 2 runs under the profiler"),
         host_pipeline_ms_per_step=host["ms_per_step"],
         train_phase_tf32_ms_per_step=train_tf32_ms,
         traced_epoch=DRIVER_EPOCHS, trace=trace,
         h2d_bytes_per_step=h2d["h2d_bytes"] / steps,
         h2d_copies_per_step=h2d["h2d_copies"] / steps,
         h2d_bytes_known=h2d["h2d_bytes_known"],
         host_pipeline_image_bytes_per_step=(N_BASE + N_BATCH) * 32 * 32 * 3,
         evals=evals, test_acc=rec["test_acc"], loss=rec["loss"],
         train_acc=rec["train_acc"], chance=100.0 / NUM_CLASSES,
         k1_launches=k1_launches, k2_launches=k2_launches,
         resident_encode_rows=DD_CHECK_ROWS,
         resident_encode_bitwise=bitwise)
    check(rec["loader_backend"] == "device", "augmentation on the card")
    check(len(rec["loss"]) == DRIVER_EPOCHS
          and all(math.isfinite(v) for v in rec["loss"]),
          "finite loss every epoch")
    check(k1_launches == DRIVER_EPOCHS * steps,
          f"K1 once a GL step ({k1_launches} in {DRIVER_EPOCHS * steps})")
    check(len(evals) == DRIVER_EPOCHS + 1 and k2_launches == len(evals)
          and all(e["n_nodes"] == EVAL_N for e in evals),
          f"K2 once in each of {DRIVER_EPOCHS + 1} resident evals of "
          f"{EVAL_N} nodes ({k2_launches})")
    check(all(e["cg_err"] <= 1e-10 for e in evals),
          f"every eval's CG converged ({[e['cg_err'] for e in evals]})")
    check(all(a > 100.0 / NUM_CLASSES for a in rec["test_acc"]),
          f"every eval's accuracy above chance ({rec['test_acc']})")
    check(h2d["h2d_bytes_known"] and h2d["h2d_bytes"] / steps
          <= DD_MAX_H2D_BYTES_PER_STEP,
          f"host-to-device bytes a step ({h2d}) within "
          f"{DD_MAX_H2D_BYTES_PER_STEP}")
    check(bitwise, "the resident encode equals the streaming encode")
    return dict(k1_launches=k1_launches, k2_launches=k2_launches,
                work=work, ckpt=last)


def phase_compare() -> int:
    """compare_to_mlp at the CLI defaults on the synthetic CIFAR-geometry
    set, and a check that one step's GL loss comes from the parameters
    before its update; returns K1's launches in the driver's run."""
    import copy
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from graphlearninglayer_tpu_torch.data import (CHANNEL_STATS,
                                                   normalize_batch)
    from graphlearninglayer_tpu_torch.models import BuildNet
    from graphlearninglayer_tpu_torch.ops import laplace_learning
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2
    from graphlearninglayer_tpu_torch.train import (compare_to_mlp,
                                                    create_train_state,
                                                    custom_ce_loss,
                                                    make_lr_schedule)
    from graphlearninglayer_tpu_torch.train.trainer import _device_normalize

    torch.backends.cudnn.allow_tf32 = True
    home = os.getcwd()
    work = tempfile.mkdtemp(prefix="gll_compare_")
    try:
        os.chdir(work)
        k1.fused_affinity_sym.launches = 0
        rec = compare_to_mlp.main([
            "--dataset", "cifar10", "--synth_n_train", str(COMPARE_TRAIN),
            "--synth_n_test", "1000", "--epochs", str(SHORT_EPOCHS)])
        launches = k1.fused_affinity_sym.launches
        saved = os.path.isfile(os.path.join(
            work, "save", "_Sup_and_SS", os.listdir(os.path.join(
                work, "save", "_Sup_and_SS"))[0], "compare_records.npy"))
    finally:
        os.chdir(home)
        shutil.rmtree(work, ignore_errors=True)
    steps = rec["steps_per_epoch"]

    # one step at the same shape: its GL loss is the one of the model as
    # it was before the step (eval mode, pre-update BN statistics)
    rng = np.random.default_rng(SEED + 6)
    images = rng.integers(0, 256, (N_BASE + N_BATCH, 32, 32, 3), np.uint8)
    labels = rng.integers(0, NUM_CLASSES, N_BASE + N_BATCH)
    norm = CHANNEL_STATS["cifar10"]
    base_x = normalize_batch(images[:N_BASE], *norm)
    state = create_train_state(
        BuildNet("resnet18", num_classes=NUM_CLASSES,
                 generator=torch.Generator().manual_seed(SEED)),
        make_lr_schedule(0.01, 1, 1))
    # epsilon 1: the CLI's default, as in the driver's run above
    step = compare_to_mlp.make_compare_step(NUM_CLASSES, base_x,
                                            labels[:N_BASE], tau=TAU,
                                            epsilon=1.0, k=K, norm=norm)
    before = copy.deepcopy(state.model)
    state, _, gl_loss = step(state, images[N_BASE:], labels[N_BASE:])
    x = torch.cat([_device_normalize(torch.from_numpy(base_x).cuda(), None),
                   _device_normalize(torch.from_numpy(images[N_BASE:])
                                     .cuda(), norm)])
    y = F.one_hot(torch.as_tensor(labels[:N_BASE]).cuda(), NUM_CLASSES)
    target = torch.as_tensor(labels[N_BASE:]).cuda()

    @torch.no_grad()
    def gl_loss_of(model):
        model.eval()
        _, feats = model(x)
        return custom_ce_loss(laplace_learning(
            feats, y.float(), tau=TAU, epsilon=1.0, k=K), target).item()

    pre, post = gl_loss_of(before), gl_loss_of(state.model)
    result = dict(steps_per_epoch=steps, epochs=SHORT_EPOCHS,
                  epoch_s=rec["epoch_s"],
                  ms_per_step=[1e3 * s / steps for s in rec["epoch_s"]],
                  mlp_loss=rec["mlp_loss"], gl_loss=rec["gl_loss"],
                  k1_launches=launches, records_saved=saved,
                  step_gl_loss=gl_loss.item(), pre_update_gl_loss=pre,
                  post_update_gl_loss=post)
    emit("compare", train=COMPARE_TRAIN, **result)
    check(launches == SHORT_EPOCHS * steps,
          f"compare: K1 once a step ({launches} in {SHORT_EPOCHS * steps})")
    check(all(math.isfinite(v) for v in rec["mlp_loss"] + rec["gl_loss"]),
          "compare: finite losses")
    check(saved, "compare: compare_records.npy written")
    check(abs(gl_loss.item() - pre) <= 1e-5 * abs(pre) and post != pre,
          f"compare: the GL loss is the pre-update model's ({gl_loss.item()}"
          f" against {pre} before and {post} after the update)")
    return launches


def phase_supcon() -> dict:
    """SupCon and SimCLR, on the host path and with --device_data,
    ResNet-18 at batch 1250 x 2 views; each checkpoint restored."""
    import os
    import tempfile

    import torch

    from graphlearninglayer_tpu_torch.config.cli import parse_option
    from graphlearninglayer_tpu_torch.models import BuildNet
    from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                    make_lr_schedule, supcon)
    from graphlearninglayer_tpu_torch.utils.checkpoint import \
        restore_checkpoint

    torch.backends.cudnn.allow_tf32 = True
    home = os.getcwd()
    work = tempfile.mkdtemp(prefix="gll_supcon_")
    runs = []
    try:
        os.chdir(work)
        for method in ("SupCon", "SupCE"):        # SupCE trains SimCLR
            for extra in ([], ["--device_data"]):
                path = "device" if extra else "host"
                argv = ["--dataset", "cifar10", "--synth_n_train",
                        str(SUPCON_TRAIN), "--synth_n_test", "100",
                        "--epochs", str(SHORT_EPOCHS), "--sup_method",
                        method, "--train_prefix", path] + extra
                rec = supcon.main(argv)
                state, epoch = restore_checkpoint(
                    os.path.join(parse_option(argv).save_folder, "supcon"),
                    create_train_state(BuildNet("resnet18"),
                                       make_lr_schedule(0.01, 1, 1)))
                steps = rec["steps_per_epoch"]
                run = dict(method="SupCon" if method == "SupCon"
                           else "SimCLR", path=path, loss=rec["loss"],
                           epoch_s=rec["epoch_s"], steps_per_epoch=steps,
                           ms_per_step=[1e3 * s / steps
                                        for s in rec["epoch_s"]],
                           restored_epoch=epoch, restored_step=state.step)
                runs.append(run)
                check(len(rec["loss"]) == SHORT_EPOCHS
                      and all(math.isfinite(v) for v in rec["loss"]),
                      f"supcon {method} {path}: finite losses")
                check(epoch == SHORT_EPOCHS
                      and state.step == SHORT_EPOCHS * steps,
                      f"supcon {method} {path}: checkpoint restored")
    finally:
        os.chdir(home)
        shutil.rmtree(work, ignore_errors=True)
    emit("supcon", train=SUPCON_TRAIN, batch=N_BATCH, views=2, runs=runs)
    return {f"{r['method']}_{r['path']}": r["ms_per_step"][-1] for r in runs}


def phase_visualize(ckpt: str) -> dict:
    """The visualize CLI on the device_data run's last checkpoint."""
    import contextlib
    import importlib
    import io

    import numpy as np

    # the module (the package's name 'visualize' is its function)
    viz = importlib.import_module(
        "graphlearninglayer_tpu_torch.evalx.visualize")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        feats = viz.main([ckpt, "--dataset", "cifar10", "--max_points",
                          str(VIZ_POINTS), "--probe"])
    out = buf.getvalue()
    lines = [ln for ln in out.splitlines()
             if "skipped" in ln or "Accuracy" in ln or "restored" in ln]
    shapes = {k: list(v[0].shape) for k, v in feats.items()}
    result = dict(wall_s=time.perf_counter() - t0, shapes=shapes,
                  lines=lines)
    emit("visualize", **result)
    check(shapes == {"train": [VIZ_POINTS, 128],
                     "test": [min(VIZ_POINTS, 1024), 128]},
          f"visualize: features of the expected counts ({shapes})")
    check(all(np.isfinite(v[0]).all() for v in feats.values()),
          "visualize: finite features")
    check(f"restored checkpoint epoch {DRIVER_EPOCHS}" in out,
          "visualize: the checkpoint restored")
    check(("plots skipped" in out or "_umap.png" in out)
          and ("probe skipped" in out or "Classifier Accuracy" in out),
          "visualize: plots and probe ran or said skipped")
    return result


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_two_ranks() -> dict:
    """Two ranks sharing the card over gloo (the launcher's variables, one
    process each), through the driver's CLI entry point: 1 epoch of 8
    GL steps and two 60,250-node evals (epoch 0 and the end), which the
    edge-sharded solve carries; held against the single-device driver run
    at the same seed: every step's loss within PAR_LOSS_RTOL relative, each
    epoch-0 eval's accuracy (the same weights) within PAR_ACC_POINTS
    points; the final eval is reported beside two single-device runs (see
    below).  K1 once a step on each
    rank, K2 once a rank an eval over that rank's half of the rows.  Both
    runs convolve in full float32: with TF32 a rank's 750-row batch and one
    1,500-row batch round differently (TF32 keeps 10 mantissa bits), which
    moves the first step's loss by ~1.6e-4.  Both refresh the base set at
    random (the same draws from the seed): the default score refresh ranks
    per-sample entropies whose near-ties flip under 1e-5 of noise, so the
    final eval would take another labeled set and move by points (PERF.md,
    PR 9)."""
    import os
    import shutil
    import tempfile

    import torch

    from graphlearninglayer_tpu_torch.train import fullysup

    torch.backends.cudnn.allow_tf32 = False
    argv = DRIVER_ARGV + ["--synth_n_train", str(PAR_TRAIN),
                          "--synth_n_test", str(PAR_TEST), "--epochs", "1",
                          "--gl_update_base_mode", "random"]
    home, work = os.getcwd(), tempfile.mkdtemp(prefix="gll_ranks_")
    try:
        os.chdir(work)
        t0 = time.perf_counter()
        one = fullysup.main(argv + ["--mesh", "off",
                                    "--train_prefix", "single"])
        single_s = time.perf_counter() - t0
        # the same run with cuDNN's deterministic algorithms: another
        # float32 summation order, the spread of the single-device run
        torch.backends.cudnn.deterministic = True
        other = fullysup.main(argv + ["--mesh", "off",
                                      "--train_prefix", "single_det"])
        torch.backends.cudnn.deterministic = False
        port = _free_port()
        env = dict(os.environ, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=home)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_CHILD, *argv,
             "--train_prefix", "ranks"],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        ranks_s = time.perf_counter() - t0
        from graphlearninglayer_tpu_torch.config.cli import parse_option

        def last(prefix):
            folder = parse_option(argv + ["--train_prefix",
                                          prefix]).save_folder
            return torch.load(os.path.join(folder, "last",
                                           "ckpt_epoch_1.pth"),
                              map_location="cpu")["model"]

        def apart(a, b):
            """Max difference of the parameters and of the BN running
            statistics, each relative to the tensor's largest entry."""
            out = {"params": 0.0, "bn_running": 0.0}
            for key, w in b.items():
                if key.endswith("num_batches_tracked"):
                    continue
                rel = ((a[key] - w).abs().max()
                       / w.abs().max().clamp_min(1e-30)).item()
                group = "bn_running" if "running" in key else "params"
                out[group] = max(out[group], rel)
            return out

        ck = {p: last(p) for p in ("single", "single_det", "ranks")}
        weights_apart = {"ranks_vs_single": apart(ck["ranks"], ck["single"]),
                         "single_det_vs_single": apart(ck["single_det"],
                                                       ck["single"])}
    finally:
        os.chdir(home)
        shutil.rmtree(work, ignore_errors=True)
        torch.backends.cudnn.allow_tf32 = True
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-4000:], file=sys.stderr)
        check(p.returncode == 0, f"two-rank driver: rank {r} exited "
              f"{p.returncode}")
    res = [json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("RANK_RESULT "))[12:])
           for out in outs]
    half = EVAL_N // 2
    loss_rel = [abs(a - b) / abs(b) for a, b in
                zip(res[0]["step_loss"], one["step_loss"])]
    acc_diff = [abs(a - b) for a, b in zip(res[0]["test_acc"],
                                           one["test_acc"])]
    emit("parallel_two_ranks", backend=res[0]["mesh"]["backend"],
         cudnn_tf32=False, matmul_tf32=False,
         mesh=res[0]["mesh"], argv=argv, single_wall_s=single_s,
         ranks_wall_s=ranks_s, step_loss=res[0]["step_loss"],
         single_step_loss=one["step_loss"], step_loss_rel=loss_rel,
         test_acc=res[0]["test_acc"], single_test_acc=one["test_acc"],
         single_det_test_acc=other["test_acc"],
         single_det_step_loss=other["step_loss"],
         weights_apart=weights_apart,
         evals=res[0]["evals"],
         single_evals=[{k: e[k] for k in ("cg_iters", "cg_err", "solve_s",
                                          "route")} for e in one["eval"]],
         epoch_s=res[0]["epoch_s"], single_epoch_s=one["epoch_s"],
         k1_launches=[r["k1_launches"] for r in res],
         k2_launches=[r["k2_launches"] for r in res],
         k2_rows=[r["k2_rows"] for r in res],
         route_printed=["edge-sharded over 2 devices" in out
                        for out in outs])
    check(res[0]["mesh"] == {"data": 1, "graph": 2, "backend": "gloo"},
          f"two ranks share the card over gloo ({res[0]['mesh']})")
    check(len(res[0]["step_loss"]) == 8 == len(one["step_loss"]),
          "8 steps in each run")
    check(max(loss_rel) <= PAR_LOSS_RTOL,
          f"two-rank step losses within {PAR_LOSS_RTOL} ({loss_rel})")
    # the epoch-0 eval sees the same weights: the edge-sharded route
    # against the single-device solve.  After 8 steps the single-device run
    # is itself chaotic (another cuDNN summation order moves its weights
    # and its final eval by points: weights_apart, single_det_test_acc), so
    # the final eval is reported, converged and above chance
    check(len(acc_diff) == 2 and acc_diff[0] <= PAR_ACC_POINTS,
          f"two-rank epoch-0 eval accuracy within {PAR_ACC_POINTS} points "
          f"({res[0]['test_acc']} against {one['test_acc']})")
    check(all(a > 100.0 / NUM_CLASSES for a in res[0]["test_acc"]),
          f"two-rank evals above chance ({res[0]['test_acc']})")
    check(all(e["route"] == "edge_sharded" and e["n_nodes"] == EVAL_N
              and e["cg_err"] <= 1e-10 for e in res[0]["evals"]),
          "every two-rank eval edge-sharded, 60,250 nodes, converged")
    check("edge-sharded over 2 devices" in outs[0],
          "the edge-sharded route printed")
    check([r["k1_launches"] for r in res] == [8, 8],
          "K1 once a step on each rank")
    check(res[0]["k2_rows"] == [[0, half]] * 2
          and res[1]["k2_rows"] == [[half, EVAL_N]] * 2,
          f"K2 once a rank an eval, over its half ({res[0]['k2_rows']}, "
          f"{res[1]['k2_rows']})")
    return dict(k1=[r["k1_launches"] for r in res],
                k2=[r["k2_launches"] for r in res])


def phase_world_of_one() -> dict:
    """A process group of one rank over NCCL.  The sharded GL step at full
    width (ResNet-18, 250 + 1250, k=25, tau 0.07, eps auto, TF32
    convolutions, cuDNN deterministic) for PAR_STEPS steps beside the
    single-device step, step by step: before each step the single-device
    model takes the sharded one's weights and statistics, and both step on
    the same batch; each step's loss within PAR_STEP_RTOL relative, K1 once
    a step, ms a step beside the single-device step's.  (Run free, the two
    trajectories part after the first step, by 1.6e-4 at the second and up
    to 9% by the sixth on an H100: the early training amplifies float32
    rounding, as the pair of single-device runs in phase_two_ranks shows.)  Then the edge-sharded and the
    row-sharded solves at 60,250 nodes (d=128, k=50, tau 1e-8) against the
    single-device solve on the same features: residual <= 1e-10, >= 99.9%
    equal argmax, s a solve, K2 once a build."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from graphlearninglayer_tpu_torch.data import (CHANNEL_STATS,
                                                   synthetic_dataset)
    from graphlearninglayer_tpu_torch.ops import (one_hot_encode,
                                                  transductive_laplace)
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2
    from graphlearninglayer_tpu_torch.ops.kernels import ell_spmm as p3
    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2
    from graphlearninglayer_tpu_torch.parallel import (
        edge_sharded_transductive_laplace, global_mesh,
        initialize_multihost, sharded_transductive_laplace)
    from graphlearninglayer_tpu_torch.train import (
        make_gl_train_step, make_sharded_gl_train_step, metrics_to_host)

    check(initialize_multihost(f"tcp://127.0.0.1:{_free_port()}", 1, 0, 0,
                               "cuda"), "a process group of one")
    try:
        check(dist.get_backend() == "nccl", "the world of one is on NCCL")
        mesh = global_mesh(("data", "graph"))
        spec = synthetic_dataset(num_classes=NUM_CLASSES,
                                 image_shape=(32, 32, 3), n_train=4000,
                                 n_test=10, seed=SEED + 5)
        images, labels = spec.train_images, spec.train_labels
        rng = np.random.default_rng(SEED + 5)
        norm = CHANNEL_STATS["cifar10"]
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = True
        kw = dict(tau=TAU, epsilon="auto", k=K, norm=norm)
        single, sharded = _new_state(torch.float32, "cuda"), \
            _new_state(torch.float32, "cuda")
        plain_step = make_gl_train_step(NUM_CLASSES, device="cuda", **kw)
        mesh_step = make_sharded_gl_train_step(NUM_CLASSES, mesh, **kw)
        rows, ms_single, ms_sharded, k1_sharded = [], [], [], 0
        for i in range(PAR_STEPS):
            idx = rng.permutation(len(images))[:N_BASE + N_BATCH]
            args = (images[idx[:N_BASE]], labels[idx[:N_BASE]],
                    images[idx[N_BASE:]], labels[idx[N_BASE:]])
            single.model.load_state_dict(sharded.model.state_dict())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single, ma, sa = plain_step(single, *args)
            la = metrics_to_host(ma)["loss"]
            t1 = time.perf_counter()
            before = k1.fused_affinity_sym.launches
            sharded, mb, sb = mesh_step(sharded, *args)
            lb = metrics_to_host(mb)["loss"]
            t2 = time.perf_counter()
            k1_sharded += k1.fused_affinity_sym.launches - before
            ms_single.append(1e3 * (t1 - t0))
            ms_sharded.append(1e3 * (t2 - t1))
            rows.append(dict(step=i, loss_single=la, loss_sharded=lb,
                             rel=abs(la - lb) / abs(la),
                             scores_max_abs=(sa - sb).abs().max().item()))
        torch.backends.cudnn.deterministic = False
        emit("parallel_train", world=1, backend="nccl", steps=rows,
             ms_per_step_single=statistics.median(ms_single[1:]),
             ms_per_step_sharded=statistics.median(ms_sharded[1:]),
             cudnn_tf32=True, cudnn_deterministic=True,
             k1_launches=k1_sharded)
        check(all(r["rel"] <= PAR_STEP_RTOL for r in rows),
              f"sharded step losses within {PAR_STEP_RTOL} of the "
              f"single-device step's ({[r['rel'] for r in rows]})")
        check(k1_sharded == PAR_STEPS, f"K1 once a sharded step "
              f"({k1_sharded} in {PAR_STEPS})")
        del single, sharded, plain_step, mesh_step
        torch.cuda.empty_cache()

        graph_mesh = global_mesh(("graph",))
        x, lab = clustered_features(EVAL_N, SEED + 1)
        x = x.cuda()
        y = one_hot_encode(torch.as_tensor(lab[:EVAL_BASE]),
                           NUM_CLASSES).cuda()
        want, it_w, err_w = transductive_laplace(
            x, y, knn_num=EVAL_K, tau=EVAL_TAU, return_info=True)
        solves = {}
        for name, fn in (("edge_sharded", edge_sharded_transductive_laplace),
                         ("row_sharded", sharded_transductive_laplace)):
            runs = []
            for _ in range(2):
                before = k2.fused_knn.launches
                p3_before = p3.ell_gather_spmm.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred, iters, err = fn(graph_mesh, x, y, knn_num=EVAL_K,
                                      tau=EVAL_TAU, return_info=True)
                torch.cuda.synchronize()
                runs.append(dict(
                    s=time.perf_counter() - t0, cg_iters=iters, cg_err=err,
                    k2_launches=k2.fused_knn.launches - before,
                    p3_launches=p3.ell_gather_spmm.launches - p3_before))
            agree = (pred.argmax(1) == want.argmax(1)).float().mean().item()
            solves[name] = dict(runs=runs, argmax_agreement=agree,
                                s_per_solve=runs[-1]["s"])
            check(all(r["cg_err"] <= 1e-10 for r in runs),
                  f"{name} solve converged ({runs})")
            check(agree >= 0.999, f"{name} argmax agreement {agree} >= 0.999")
            check(all(r["k2_launches"] == 1 for r in runs),
                  f"{name}: K2 once a build")
            # the row-sharded CG's matvec is P3 on the rank's rows: the
            # right-hand side, the start residual and one a CG step; the
            # edge-sharded halo CG runs none
            check(all(r["p3_launches"] == (r["cg_iters"] + 2
                                           if name == "row_sharded" else 0)
                      for r in runs), f"{name}: P3 launches ({runs})")
        emit("parallel_solve", world=1, backend="nccl", n=EVAL_N, k=EVAL_K,
             tau=EVAL_TAU, single_cg_iters=it_w, single_cg_err=err_w,
             **solves)
        return dict(k1=k1_sharded,
                    k2={n: sum(r["k2_launches"] for r in v["runs"])
                        for n, v in solves.items()},
                    p3=sum(r["p3_launches"]
                           for r in solves["row_sharded"]["runs"]))
    finally:
        dist.destroy_process_group()


def phase_banded(k2_full_ms: float) -> dict:
    """The GLL_BANDED_KNN=1 route: a cached 60,250-node solve on features
    drifted by 1e-4 from the ones that planned the cache's permutation;
    its time beside the same cached solve through K2, the banded build
    alone beside K2's full build, and its fallback fraction."""
    import os

    import torch

    from graphlearninglayer_tpu_torch.ops import (EvalGraphCache,
                                                  one_hot_encode,
                                                  transductive_laplace)
    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2
    from graphlearninglayer_tpu_torch.ops.knn_banded import banded_knn

    x, lab = clustered_features(EVAL_N, SEED + 1)
    x = x.cuda()
    y = one_hot_encode(torch.as_tensor(lab[:EVAL_BASE]), NUM_CLASSES).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    drift = [x + 1e-4 * torch.randn(x.shape, generator=gen, device="cuda")
             for _ in range(3)]
    out = {}
    for route in ("k2", "banded"):
        cache = EvalGraphCache()
        transductive_laplace(x, y, knn_num=EVAL_K, tau=EVAL_TAU, cache=cache)
        os.environ["GLL_BANDED_KNN"] = "1" if route == "banded" else "0"
        try:
            runs = []
            for xi in drift:
                before = k2.fused_knn.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred, iters, err = transductive_laplace(
                    xi, y, knn_num=EVAL_K, tau=EVAL_TAU, return_info=True,
                    cache=cache)
                torch.cuda.synchronize()
                runs.append(dict(s=time.perf_counter() - t0, cg_iters=iters,
                                 cg_err=err, k2_launches=(
                                     k2.fused_knn.launches - before)))
        finally:
            os.environ.pop("GLL_BANDED_KNN", None)
        out[route] = dict(runs=runs, pred=pred, perm=cache.perm)
    agree = (out["banded"]["pred"].argmax(1)
             == out["k2"]["pred"].argmax(1)).float().mean().item()
    perm = out["banded"]["perm"].cpu().numpy()
    nbr, _, frac = banded_knn(drift[-1], EVAL_K, perm, block=256, band=32)
    build_ms = cuda_ms(lambda: banded_knn(drift[-1], EVAL_K, perm,
                                          block=256, band=32),
                       reps=3, warmup=1)
    emit("banded", n=EVAL_N, k=EVAL_K, block=256, band=32,
         solves={r: v["runs"] for r, v in out.items()},
         argmax_agreement=agree, fallback_frac=frac,
         certified=nbr is not None, banded_build_ms=build_ms,
         k2_full_build_ms=k2_full_ms,
         s_per_solve={r: statistics.mean(x["s"] for x in v["runs"][1:])
                      for r, v in out.items()})
    check(all(r["cg_err"] <= 1e-10 for v in out.values() for r in v["runs"]),
          "banded and K2 cached solves converged")
    check(agree >= 0.999, f"banded vs K2 argmax agreement {agree}")
    check(all(r["k2_launches"] == 1 for r in out["k2"]["runs"]),
          "K2 once a cached solve")
    return dict(fallback_frac=frac, banded_build_ms=build_ms)


def _captured(fn):
    """``(fn(), text)``: what ``fn`` and the processes it starts write to
    this process's stdout and stderr (file descriptors 1 and 2), kept out
    of the smoke's own output.  If ``fn`` raises, the text's tail goes to
    stderr first."""
    import os
    import tempfile

    with tempfile.TemporaryFile(mode="w+") as f:
        sys.stdout.flush()
        sys.stderr.flush()
        saved = os.dup(1), os.dup(2)
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
        ok = False
        try:
            result = fn()
            ok = True
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os.dup2(saved[0], 1)
            os.dup2(saved[1], 2)
            os.close(saved[0])
            os.close(saved[1])
            f.seek(0)
            text = f.read()
            if not ok:
                print(text[-4000:], file=sys.stderr)
    return result, text


# entry()'s scores against the CPU float64 forward on the card's graph
# (phase_entry): above the op phase's 1e-4, which float32 itself exceeds
# on the random-weight ResNet's crowded features
ENTRY_PRED_TOL = 3e-4


def phase_entry() -> dict:
    """entry() at the flagship shape (ResNet-18, 250 + 1,250 nodes, k=25,
    float32, TF32 off): its forward's ms (CUDA events, median of 10 after a
    warm-up), K1 exactly once a forward, and the scores against the same
    forward through the port on the CPU in float64 (entry(device="cpu",
    dtype=torch.float64) draws the same weights and images).

    The random-weight ResNet's features crowd together: rows whose K-th
    and (K+1)-th neighbors lie closer in squared distance than the card's
    float32 ranking resolves them (|x|^2 + |y|^2 - 2 x.y, whose error
    against float64 is measured at the card's lists) take either
    neighbor, and the two forwards then solve on two graphs.  So the KNN
    sets must agree on every row outside that tie band (twice the largest
    ranking error), and the scores are compared once the CPU's float64 op
    takes the card's neighbor sets.  W reads each kept edge's d2 from the
    rows' difference, whose float32 error (d2_max_abs_err) is far below
    the ranking's; the rows within twice it are counted too
    (rows_in_value_band).  The bar is ENTRY_PRED_TOL, fixed from the H100
    readings when W read the ranking's d2: 1.155e-4 for the card, 2.03e-4
    for the port's float32 op on the CPU on the card's features and graph,
    which is printed beside it.  The free-running CPU forward's
    difference and the features' are reported."""
    import torch

    from graphlearninglayer_tpu_torch.entry import entry
    from graphlearninglayer_tpu_torch.ops import dense_mode, laplace_learning
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2

    knn = dense_mode.knn
    seen = {}

    def recorded(name):
        def call(x, k, d2=None):
            seen[name] = knn(x, k, d2=d2)
            return seen[name]
        return call

    def with_features(model):
        feats = []
        model.register_forward_hook(lambda m, i, o: feats.append(o[1]))
        return feats

    torch.backends.cudnn.allow_tf32 = False
    try:
        forward, args = entry()
        feats = with_features(args[0])
        before = k1.fused_affinity_sym.launches
        dense_mode.knn = recorded("card")
        try:
            scores = forward(*args)
        finally:
            dense_mode.knn = knn
        torch.cuda.synchronize()
        first = k1.fused_affinity_sym.launches - before
        before = k1.fused_affinity_sym.launches
        ms = cuda_ms(lambda: forward(*args), reps=10, warmup=1)
        timed = k1.fused_affinity_sym.launches - before
    finally:
        torch.backends.cudnn.allow_tf32 = True
    forward64, args64 = entry(device="cpu", dtype=torch.float64)
    feats64 = with_features(args64[0])
    t0 = time.perf_counter()
    dense_mode.knn = recorded("cpu")
    try:
        free = forward64(*args64)
    finally:
        dense_mode.knn = knn
    cpu_s = time.perf_counter() - t0
    f64 = feats64[0]
    d2 = dense_mode.pairwise_dist2(f64, f64)
    card_nbr = seen["card"][0].cpu()
    # the card's ranking d2 (float32 Gram form) at its lists
    ranked32 = dense_mode.pairwise_dist2(feats[0], feats[0]).gather(
        1, card_nbr.to(feats[0].device)).double().cpu()
    # the CPU's float64 op, and its float32 op on the card's features, on
    # the card's neighbor sets
    dense_mode.knn = lambda x, k, d2=None: (card_nbr,
                                            kept_dist2(x, x, card_nbr))
    try:
        y = torch.nn.functional.one_hot(args64[2], NUM_CLASSES).double()
        pinned = laplace_learning(f64, y, tau=TAU, epsilon="auto", k=K)
        cpu32 = laplace_learning(feats[0].cpu(), y.float(), tau=TAU,
                                 epsilon="auto", k=K)
    finally:
        dense_mode.knn = knn
    host = scores.double().cpu()
    err = (host - pinned).abs().max().item()
    err32 = (cpu32.double() - pinned).abs().max().item()
    tol = ENTRY_PRED_TOL
    err_free = (host - free).abs().max().item()
    exact = kept_dist2(f64, f64, card_nbr)[:, 1:]
    d2_err = (seen["card"][1].double().cpu()[:, 1:]
              - exact).abs().max().item()
    rank_err = (ranked32[:, 1:] - exact).abs().max().item()
    cpu_nbr = seen["cpu"][0]
    differ = (card_nbr.sort(1).values != cpu_nbr.sort(1).values).any(1)
    ranked = d2.clone()
    ranked.fill_diagonal_(-1.0)
    near = torch.topk(ranked, K + 1, dim=1, largest=False).values
    gap = near[:, K] - near[:, K - 1]
    band = 2.0 * rank_err
    emit("entry", n=N_BASE + N_BATCH, k=K, tau=TAU, model="resnet18",
         cudnn_tf32=False, matmul_tf32=False,
         scores_shape=list(scores.shape), forward_ms=ms,
         k1_launches_first=first, k1_launches_timed=timed,
         pred_max_abs_err=err, pred_tol=tol,
         cpu_f32_pred_max_abs_err=err32, pred_max_abs_err_free=err_free,
         feat_max_abs_err=(feats[0].double().cpu() - f64).abs().max().item(),
         d2_max_abs_err=d2_err, rank_d2_max_abs_err=rank_err,
         tie_band=band, rows_in_band=int((gap <= band).sum()),
         value_band=2.0 * d2_err,
         rows_in_value_band=int((gap <= 2.0 * d2_err).sum()),
         rows_knn_differ=int(differ.sum()),
         min_knn_gap=gap.min().item(), cpu_f64_forward_s=cpu_s)
    check(bool(torch.isfinite(scores).all()), "entry() scores finite")
    check(tuple(scores.shape) == (N_BATCH, NUM_CLASSES),
          f"entry() scores of shape {tuple(scores.shape)}")
    check(first == 1 and timed == 11,
          f"K1 once a forward ({first} in one, {timed} in 11)")
    check(bool((gap[differ] <= band).all()),
          "the card's and the CPU's KNN sets agree outside the tie band")
    check(err <= tol, f"entry() scores within {tol} of the CPU float64 "
          f"forward on the card's graph ({err})")
    return dict(k1=first)


# what dryrun_multichip(n) gives the kernels on each rank (the same for
# n = 1 and 2): the dense op's rows in the driver's GL steps (base + batch),
# at d 128 and k 6 (--knn_k 6), and the driver evals' nodes, at d 128 and
# k = every node (the eval's knn_num is min(50, nodes)); the solves' 32n
# nodes of 8 dims at k 6 and the attack's 6n rows of 16 features at k 4
# come from the dry run's own draws
DRYRUN_OP_N = {1: 13, 2: 18}
DRYRUN_EVAL_N = {1: 25, 2: 42}
# K1 and K2 launches on each rank, by part: the driver's two runs of three
# GL steps (12n images, batches of 4n) with an eval before and after each;
# one KNN build in each solve; the FGSM's two op calls in dense mode
DRYRUN_K1 = dict(driver=6, solves=0, attack=2)
# float32 ulps of d2 (of |x_i|^2 + |x_j|^2) that K1 and its plain version
# may differ by together at the dry run's shapes (dryrun_kernels): each
# forms a kept entry's d2 from the rows' difference in float32, within
# fewer than 4
K1_D2_ULPS = 8
DRYRUN_K2 = dict(driver=4, solves=2, attack=0)


def dryrun_p3(rank: dict) -> dict:
    """P3 launches on a dry-run rank, by part: none in the driver (its evals
    are edge-sharded or single-device BSR / sorted) or the FGSM; in the
    solves the row-sharded CG's, its iterations + 2 (the right-hand side,
    the start residual, one a CG step)."""
    return dict(driver=0, solves=rank["row_solve_iters"] + 2, attack=0)


def dryrun_kernels(n: int) -> dict:
    """K1 and K2 against their plain versions at the shapes that
    dryrun_multichip(n) gives them on each rank.  K2 (k2_against_plain's
    bar) on the full rows and on each rank's range [r N / n, (r + 1) N /
    n) of the sharded builds, each range also bit for bit the full call's
    rows: at the solves' nodes (the dry run's draws, k 6) and at the
    driver evals' size (unit features, k = every node).  K1 on the
    attack's first op call (the dry run's attack network on its draws, k
    4) and at the driver's GL step size (unit features, k 6), entry by
    entry within K1_TOL plus what K1_D2_ULPS float32 ulps of d2's terms
    |x_i|^2 + |x_j|^2 move W = exp(-4 d2 / (eps_i eps_j)) by (4 W ulps /
    (eps_i eps_j), W in float64).  At these few nodes eps is near 0.1, so
    W multiplies d2's rounding by ~400: the plain version alone lies
    4.6e-6 (6 nodes) and 8.5e-6 (12) from float64 on the attack's
    features, above K1_TOL (set at 1,500 nodes, where eps is larger)."""
    import torch

    from graphlearninglayer_tpu_torch.entry import attack_network, dryrun_draws
    from graphlearninglayer_tpu_torch.ops.dense_mode import build_dense_graph
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2
    from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2

    d = dryrun_draws(n)
    out = {"k2": {}, "k1": {}}
    for name, x, k in (
            ("solves", d["x_nodes"].cuda(), 6),
            ("driver_eval", clustered_features(DRYRUN_EVAL_N[n],
                                               SEED + n)[0].cuda(),
             DRYRUN_EVAL_N[n])):
        m = x.shape[0]
        nbr, dist2 = k2.fused_knn(x, k)
        pn, pd = k2.fused_knn_plain(x, min(k + 1, m), 2048)
        errs = [k2_against_plain(nbr, dist2, pn, pd, 0,
                                 f"dryrun({n}) {name}, all rows")["err"]]
        for r in range(n):
            r0, r1 = r * m // n, (r + 1) * m // n
            hn, hd = k2.fused_knn(x, k, rows=(r0, r1))
            qn, qd = k2.fused_knn_plain(x, min(k + 1, m), 2048,
                                        rows=(r0, r1))
            errs.append(k2_against_plain(
                hn, hd, qn, qd, r0,
                f"dryrun({n}) {name}, rows {r0}:{r1}")["err"])
            check(torch.equal(hn, nbr[r0:r1]) and torch.equal(hd,
                                                              dist2[r0:r1]),
                  f"dryrun({n}) {name}: K2 rows {r0}:{r1} equal the full "
                  f"call's bit for bit")
        out["k2"][name] = dict(n=m, d=x.shape[1], k=k, max_abs_err=max(errs))
    with torch.no_grad():
        feats = attack_network().cuda()(torch.cat(
            [d["base_images"], d["images"]]).cuda())[1]
    for name, x, k in (
            ("attack", feats, 4),
            ("driver_step", clustered_features(DRYRUN_OP_N[n],
                                               SEED + 2 * n)[0].cuda(), 6)):
        g = build_dense_graph(x, k)
        args = (x.contiguous(), g.eps, g.m_raw)
        plain = k1.fused_affinity_sym_plain(*args)
        diff = (k1.fused_affinity_sym(*args) - plain).double().abs()
        x64, eps64 = x.double(), g.eps.double()
        w64 = k1.fused_affinity_sym_plain(x64, eps64, g.m_raw.double())
        sq = (x64 * x64).sum(1)
        slack = (4.0 * w64 * K1_D2_ULPS * 2.0 ** -23
                 * (sq[:, None] + sq[None, :])
                 / (eps64[:, None] * eps64[None, :]))
        share = (diff / (K1_TOL + slack)).max().item()
        check(share <= 1.0, f"dryrun({n}) {name}: K1 within K1_TOL plus "
              f"{K1_D2_ULPS} ulps of d2 of plain ({share} of the bar)")
        out["k1"][name] = dict(
            n=x.shape[0], d=x.shape[1], k=k, max_abs_err=diff.max().item(),
            bar_share=share, max_slack=slack.max().item(),
            plain_f32_err=(plain.double() - w64).abs().max().item(),
            eps_min=g.eps.min().item())
    return out


def phase_dryrun() -> dict:
    """dryrun_multichip(2) (two ranks sharing the card over gloo) and
    dryrun_multichip(1) (a world of one over NCCL), the ranks' output
    captured, after K1 and K2 are held to their plain versions at the
    shapes each run gives them (dryrun_kernels): each run's seconds,
    backend and per-rank parts, every assertion of the dry run held (it
    raises otherwise), no "exploding gradient" line, and each rank's K1
    and K2 launches by part exactly DRYRUN_K1 and DRYRUN_K2, and its P3
    launches dryrun_p3's."""
    from graphlearninglayer_tpu_torch.entry import dryrun_multichip

    runs, launches = {}, {}
    for n, backend in ((2, "gloo"), (1, "nccl")):
        kernels = dryrun_kernels(n)
        t0 = time.perf_counter()
        ranks, text = _captured(lambda: dryrun_multichip(n))
        seconds = time.perf_counter() - t0
        runs[n] = dict(seconds=seconds, backend=ranks[0]["backend"],
                       ranks=ranks, kernels=kernels)
        check(all(r["backend"] == backend for r in ranks),
              f"dryrun_multichip({n}) over {backend} "
              f"({[r['backend'] for r in ranks]})")
        check("exploding gradient" not in text,
              f"dryrun_multichip({n}) printed no exploding gradient")
        check(all(f"dryrun rank {r} of {n}: {backend} on cuda:0" in text
                  for r in range(n)),
              f"dryrun_multichip({n}): every rank printed its backend")
        for r in ranks:
            check(r["k1_launches"] == DRYRUN_K1,
                  f"dryrun_multichip({n}): K1 launches {DRYRUN_K1} on rank "
                  f"{r['rank']} ({r['k1_launches']})")
            check(r["p3_launches"] == dryrun_p3(r),
                  f"dryrun_multichip({n}): P3 launches {dryrun_p3(r)} on "
                  f"rank {r['rank']} ({r['p3_launches']})")
            check(r["k2_launches"] == DRYRUN_K2,
                  f"dryrun_multichip({n}): K2 launches {DRYRUN_K2} on rank "
                  f"{r['rank']} ({r['k2_launches']})")
        launches[n] = dict(k1=[r["k1_launches"] for r in ranks],
                           k2=[r["k2_launches"] for r in ranks],
                           p3=[r["p3_launches"] for r in ranks])
    emit("dryrun", runs={str(n): v for n, v in runs.items()})
    return launches


# the sharded attack: the attack driver's cifar10 shape (FGSM_BASE_RATE 50
# a class: 500 base + 200 batch = 700 nodes), an FGSM and an IFGSM point
ATK_BASE, ATK_BATCH = 500, 200
ATK_POINTS = (("fgsm", 0.05), ("ifgsm", 0.05))


def _attack_setup(dev):
    """The cifar10 attack's network (PreActResNet-18, random weights from
    SEED), normalized synthetic CIFAR-geometry base and batch images on
    ``dev``, and the config's data range."""
    import torch

    from graphlearninglayer_tpu_torch.data import Transform, synthetic_dataset
    from graphlearninglayer_tpu_torch.train.adversarial_driver import (
        DATASET_CONFIGS, build_network)

    cfg = DATASET_CONFIGS["cifar10"]
    spec = synthetic_dataset(num_classes=NUM_CLASSES, image_shape=(32, 32, 3),
                             n_train=ATK_BASE, n_test=ATK_BATCH,
                             seed=SEED + 9)
    tf = Transform("cifar10", "eval")

    def nchw(a):
        return torch.from_numpy(tf.normalize(a).transpose(0, 3, 1, 2)
                                .copy()).to(dev)

    net = build_network("preactresnet18", NUM_CLASSES, 3,
                        torch.Generator().manual_seed(SEED)).to(dev).eval()
    lab = lambda a: torch.as_tensor(a).long().to(dev)
    return dict(net=net, base=nchw(spec.train_images),
                base_labels=lab(spec.train_labels),
                images=nchw(spec.test_images), labels=lab(spec.test_labels),
                lo=torch.as_tensor(cfg.min_val).to(dev),
                hi=torch.as_tensor(cfg.max_val).to(dev))


def _attack_points(mesh=None) -> dict:
    """The attack points on the card, through the single-device attack
    (``mesh=None``) or the sharded one over ``mesh``: the first step's
    input gradient of this rank's batch rows, a warm-up point, then each
    point's adversarial images and predictions (on the CPU), host seconds
    (ending in the predictions' copy), K1 launches, op calls and largest
    Cholesky info, as numpy (a rank's CPU tensors would reach the parent
    through shared memory that the rank's exit frees).  The caller sets
    TF32 off and cuDNN's and PyTorch's deterministic algorithms (the dense
    op's backward sums with index_add, atomics on the card by default)."""
    import torch

    from graphlearninglayer_tpu_torch.attack import fgsm
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
    from graphlearninglayer_tpu_torch.ops.kernels.knn_topk import kept_dist2

    dev = torch.device("cuda") if mesh is None else mesh.device
    a = _attack_setup(dev)

    def encode(x):
        return a["net"](x)[1]

    op_kw = dict(tau=0.0, k=K)
    atk = fgsm.make_gl_fast_gradient_attack(encode, NUM_CLASSES, device=dev,
                                            mesh=mesh, **op_kw)
    _, batch = fgsm.gl_head(encode, NUM_CLASSES, op_kw, a["base"],
                            a["base_labels"], ATK_BATCH, mesh)
    lo, hi = batch.lo, batch.hi
    loss = fgsm.gl_loss(encode, NUM_CLASSES, op_kw, a["base"],
                        a["base_labels"], a["labels"], [], mesh)
    out = {"lo": lo, "grad": fgsm.input_grad(loss,
                                             a["images"][lo:hi]).cpu().numpy()}
    args = (a["base"], a["base_labels"], a["images"], a["labels"])
    atk(*args, ATK_POINTS[0][1], ATK_POINTS[0][0], a["lo"], a["hi"])
    for kind, eps in ATK_POINTS:
        stats = []
        before = k1.fused_affinity_sym.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adv, pred = atk(*args, eps, kind, a["lo"], a["hi"], stats)
        pred = pred.cpu().numpy()
        out[kind] = dict(s=time.perf_counter() - t0, adv=adv.cpu().numpy(),
                         pred=pred, op_calls=len(stats),
                         k1_launches=k1.fused_affinity_sym.launches - before,
                         chol_info=fgsm.max_chol_info(stats))
    return out


def _deterministic(on: bool) -> None:
    import torch

    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.allow_tf32 = not on
    torch.use_deterministic_algorithms(on, warn_only=True)


def _attack_rank() -> dict:
    """A spawned rank's sharded attack points (see _attack_points) on the
    world's mesh, with its backend."""
    from graphlearninglayer_tpu_torch.parallel import make_mesh

    _deterministic(True)
    mesh = make_mesh(axes=("data", "graph"))
    return dict(_attack_points(mesh), backend=mesh.backend)


def phase_sharded_attack() -> dict:
    """The sharded FGSM / IFGSM (make_gl_fast_gradient_attack with a mesh) at
    the cifar10 attack's shape, beside the single-device attack on the
    same network and images: in a world of one over NCCL the adversarial
    images and predictions equal the single-device attack's; over two
    ranks sharing the card (gloo) the first step's input gradient within
    1e-4 of its largest entry and >= 99% equal predictions at each point;
    K1 iters + 1 times a point on each rank; every Cholesky succeeds;
    seconds a point each way."""
    import numpy as np

    from graphlearninglayer_tpu_torch.parallel import spawn_ranks

    _deterministic(True)
    try:
        single = _attack_points()
    finally:
        _deterministic(False)
    t0 = time.perf_counter()
    one = spawn_ranks(_attack_rank, 1)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = spawn_ranks(_attack_rank, 2)
    two_s = time.perf_counter() - t0
    grad = single["grad"]
    scale = float(np.abs(grad).max())
    grad_err = {"one": float(np.abs(one[0]["grad"] - grad).max()) / scale,
                "two": float(np.abs(np.concatenate([r["grad"] for r in two])
                                    - grad).max()) / scale}
    points = {}
    for kind, eps in ATK_POINTS:
        iters = 1 if kind == "fgsm" else max(int(5 * eps / 0.05), 0)
        s, o, t = single[kind], one[0][kind], [r[kind] for r in two]
        points[kind] = dict(
            eps=eps, iters=iters, s_single=s["s"], s_world_of_one=o["s"],
            s_two_ranks=[r["s"] for r in t],
            k1_launches=dict(single=s["k1_launches"],
                             world_of_one=o["k1_launches"],
                             two_ranks=[r["k1_launches"] for r in t]),
            chol_info=[s["chol_info"], o["chol_info"]]
            + [r["chol_info"] for r in t],
            one_adv_equal=bool(np.array_equal(o["adv"], s["adv"])),
            one_pred_equal=bool(np.array_equal(o["pred"], s["pred"])),
            two_pred_agree=float(np.mean(t[0]["pred"] == s["pred"])),
            two_adv_max_abs=float(np.abs(t[0]["adv"] - s["adv"]).max()),
            two_adv_differ=float(np.mean(t[0]["adv"] != s["adv"])),
            two_ranks_same=all(np.array_equal(r["adv"], t[0]["adv"])
                               for r in t))
    emit("sharded_attack", n=ATK_BASE + ATK_BATCH, k=K, tau=0.0,
         model="preactresnet18", backends=[one[0]["backend"],
                                           two[0]["backend"]],
         cudnn_deterministic=True, tf32=False, world_of_one_wall_s=one_s,
         two_ranks_wall_s=two_s, grad_rel_err=grad_err,
         rows=[r["lo"] for r in two], points=points)
    check(one[0]["backend"] == "nccl" and two[0]["backend"] == "gloo",
          "the world of one over NCCL, two ranks over gloo")
    check(grad_err["one"] == 0.0, f"world of one: the first-step gradient "
          f"equals the single-device one ({grad_err['one']})")
    check(grad_err["two"] <= 1e-4, f"two ranks: first-step gradient within "
          f"1e-4 of its largest entry ({grad_err['two']})")
    for kind, p in points.items():
        check(p["one_adv_equal"] and p["one_pred_equal"],
              f"{kind}: the world of one's images and predictions equal "
              f"the single-device attack's")
        check(p["two_pred_agree"] >= 0.99, f"{kind}: two ranks' predictions "
              f"agree on {p['two_pred_agree']} >= 0.99")
        check(p["two_ranks_same"], f"{kind}: both ranks return one result")
        n_op = p["iters"] + 1
        kl = p["k1_launches"]
        check(kl["single"] == kl["world_of_one"] == n_op
              and kl["two_ranks"] == [n_op, n_op],
              f"{kind}: K1 iters + 1 = {n_op} times a point on each rank "
              f"({kl})")
        check(max(p["chol_info"]) == 0, f"{kind}: every Cholesky succeeded")
    return {kind: p["k1_launches"] for kind, p in points.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    k1_stats = phase_k1()
    k2_stats = phase_k2()
    phase_op()
    entry_launches = phase_entry()
    k1_launches, state, tf32_ms, k1_in_step_ms = phase_train()
    phase_parity()
    phase_solve()
    phase_solve_parity()
    ell = phase_ell()
    k2_launches = phase_transductive_eval(state)
    del state
    torch.cuda.empty_cache()
    k3_stats = phase_k3()
    probes = phase_probes()
    phase_op_edge()
    host = phase_fullysup(tf32_ms)
    adv = phase_adversarial()
    phase_device_aug()
    dd = phase_device_data(tf32_ms, host)
    try:
        phase_visualize(dd["ckpt"])
    finally:
        shutil.rmtree(dd["work"], ignore_errors=True)
    compare_launches = phase_compare()
    phase_supcon()
    two = phase_two_ranks()
    one = phase_world_of_one()
    dry = phase_dryrun()
    attack_launches = phase_sharded_attack()
    banded = phase_banded(k2_stats[EVAL_N]["ms"])
    k1_main, k2_main = k1_stats[1500], k2_stats[EVAL_N]
    p3_main = ell["per_l"][P3_CLASSES[0]]
    kernels = [{
        "name": "fused_affinity_sym",
        "route": "cuda",
        "source": "graphlearninglayer_tpu_torch/ops/kernels/csrc/"
                  "affinity_sym.cu",
        "replaces": "graphlearninglayer_tpu/ops/kernels/affinity.py:49",
        "launches": k1_launches,
        "max_abs_err": max(s["max_abs_err"] for s in k1_stats.values()),
        "ms": k1_main["ms"],
        "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"],
        "bound_by": k1_main["bound_by"],
        "library_ms": None,
        "bound_share": k1_main["bound_share"],
        "ms_l2_flushed": k1_main["ms_l2_flushed"],
        "call_ms": k1_main["call_ms"],
        "in_step_ms": k1_in_step_ms,
        # the adversarial path: launches of each of its runs, and K1's
        # device times at its shapes
        "launches_adversarial": adv["launches"],
        "adversarial_shapes": adv["k1_shapes"],
        # the compare driver's run and the --device_data driver run
        "launches_compare": compare_launches,
        "launches_device_data": dd["k1_launches"],
        # the multi-device path: the world of one's sharded steps, and the
        # two ranks' driver run (per rank)
        "launches_sharded": {"world_of_one_steps": one["k1"],
                             "two_ranks": two["k1"]},
        # the entry points: one flagship forward, the dry runs' parts per
        # rank (two ranks over gloo, a world of one over NCCL), and the
        # sharded attack's points (single device, world of one, per rank)
        "launches_entry": entry_launches["k1"],
        "launches_dryrun": {str(n): v["k1"] for n, v in dry.items()},
        "launches_sharded_attack": attack_launches,
    }, {
        "name": "fused_knn",
        "route": "cuda",
        "source": "graphlearninglayer_tpu_torch/ops/kernels/csrc/"
                  "knn_topk.cu",
        "replaces": "graphlearninglayer_tpu/ops/kernels/knn_topk.py:143",
        "launches": k2_launches,
        "max_abs_err": max(s["max_abs_err"] for s in k2_stats.values()),
        "ms": k2_main["ms"],
        "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"],
        "bound_share": k2_main["bound_ms"] / k2_main["ms"],
        "launches_device_data": dd["k2_launches"],
        # a rank's half of the rows at the eval's shape, with its
        # one-triangle bound; the sharded paths' launches (per rank in the
        # two-rank driver run, which has two evals)
        "ms_rows": {r: v["ms"] for r, v in k2_main["rows"].items()},
        "bound_ms_rows": {r: v["bound_ms"]
                          for r, v in k2_main["rows"].items()},
        "launches_sharded": dict(one["k2"], two_ranks=two["k2"]),
        "launches_dryrun": {str(n): v["k2"] for n, v in dry.items()},
        "banded_fallback_frac": banded["fallback_frac"],
    }, {
        "name": "fused_affinity",
        "route": "cuda",
        "source": "graphlearninglayer_tpu_torch/ops/kernels/csrc/"
                  "affinity_sym.cu",
        "replaces": "graphlearninglayer_tpu/ops/kernels/affinity.py:113",
        "launches": k3_stats["launches"],
        "max_abs_err": k3_stats["max_abs_err"],
        "ms": k3_stats["ms"],
        "plain_ms": k3_stats["plain_ms"],
        "bound_ms": k3_stats["bound_ms"],
        "bound_by": k3_stats["bound_by"],
        "library_ms": None,
        "bound_share": k3_stats["bound_share"],
        "ms_l2_flushed": k3_stats["ms_l2_flushed"],
        "call_ms": k3_stats["call_ms"],
    }, {
        "name": "ell_gather_spmm",
        "route": "cuda",
        "source": "graphlearninglayer_tpu_torch/ops/kernels/csrc/"
                  "ell_spmm.cu",
        "replaces": "benchmarks/probe_pallas_gather.py:47",
        # the ell phase's five ELL solves; the numbers at the solve's l=10
        # (l=100 beside them)
        "launches": ell["launches"],
        "max_abs_err": max(v["max_abs_err"] for v in ell["per_l"].values()),
        "ms": p3_main["ms"],
        "plain_ms": p3_main["plain_ms"],
        "bound_ms": p3_main["bound_ms"],
        "bound_by": p3_main["bound_by"],
        "library_ms": p3_main["library_ms"],
        "bound_share": p3_main["bound_share"],
        "ms_l2_flushed": p3_main["ms_l2_flushed"],
        "bsr_spmm_ms": p3_main["bsr_spmm_ms"],
        "slots": ell["slots"],
        "counted_slots": ell["counted_slots"],
        "used_slots": ell["used_slots"],
        "bound_ms_every_slot": p3_main["bound_ms_every_slot"],
        "l2_sector_bytes": p3_main["l2_sector_bytes"],
        "l100": {key: ell["per_l"][100][key] for key in (
            "ms", "ms_l2_flushed", "plain_ms", "library_ms", "bsr_spmm_ms",
            "bound_ms", "bound_ms_every_slot", "l2_sector_bytes")},
        # the row-sharded solves: the world of one's two, and each dry-run
        # rank's
        "launches_sharded": {"world_of_one_row_sharded": one["p3"]},
        "launches_dryrun": {str(n): v["p3"] for n, v in dry.items()},
    }, {
        "name": "row_sort",
        "route": "cuda",
        "source": "graphlearninglayer_tpu_torch/ops/kernels/csrc/"
                  "row_sort.cu",
        "replaces": "benchmarks/probe_pallas_sort.py:25",
        # on no path: the probes phase's run of the probe's cases; the
        # numbers at 256 x 512 ascending, every case's beside them
        "launches": probes["launches"]["row_sort"],
        "max_abs_err": probes["max_abs_err"]["row_sort"],
        **{key: probes["row_sort"]["256x512"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launch_floor_ms")},
        "cases": probes["row_sort"],
        "descending": probes["row_sort"]["256x512_desc"],
        # the positive max at 256 x 512, every case's beside it
        "scale_if_max_positive": dict(
            {key: probes["scale"]["positive"][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "launch_floor_ms")},
            cases=probes["scale"],
            launches=probes["launches"]["scale_if_max_positive"]),
    }, {
        "name": "take_along",
        "route": "cuda",
        "source": "graphlearninglayer_tpu_torch/ops/kernels/csrc/"
                  "take_along.cu",
        "replaces": "benchmarks/probe_gather_support.py:19",
        "launches": probes["launches"]["take_along"],
        "max_abs_err": probes["max_abs_err"]["take_along"],
        **{key: probes["take_along"]["65536x128_axis0"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launch_floor_ms", "l2_sector_bytes")},
        "cases": probes["take_along"],
    }]
    emit("done", wall_s=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
