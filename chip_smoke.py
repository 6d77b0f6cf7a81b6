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
          with CUDA-event times and the reckoned bound;
  k2      kernel K2 (fused KNN) against its plain version at the eval's
          shape (n=60,250, d=128, k=50) and at n=1500, k=25, on clustered
          features: max |dist2 diff| <= 1e-5; the same neighbor sets on
          every row outside the boundary-tie set (k-th and (k+1)-th plain
          distances within twice that measured error), and on each row
          that differs exactly one neighbor swapped at the boundary, on at
          most 0.1% of rows; CUDA-event times of the kernel, the plain
          route and one cdist + topk;
  op      laplace_learning forward + backward on the card in float32 against
          the port's float64 CPU result on the same input;
  train   20 full-width train steps in float32 (TF32 off everywhere), 20
          with float32 parameters and TF32 convolutions (cuDNN's default),
          then 5 in bf16 (encoder under autocast, TF32 off), and one eval
          step on held-out images: the main path, across which K1's launch
          count is read;
  profile torch.profiler over 3 more warm float32 steps (TF32 off): device
          time by kernel and the device's busy share;
  parity  one train step at a reduced batch (40 + 160) from identical
          weights on the card and on the CPU, TF32 off;
  solve   transductive_laplace at 60,250 nodes on clustered features with
          an EvalGraphCache: two warm-up and three timed solves, the mode
          that ran, CG iterations and residual, peak memory, and a profile
          of one more solve;
  solve_parity  the same solve at 10,250 nodes on the card (float32)
          against the port on the CPU (float64);
  transductive_eval  the eval main path: test_gl_transductive with the
          trained float32 state over 250 + 50,000 + 10,000 synthetic
          images, across which K2's launch count is read;
  k3      kernel K3 (affinity times a precomputed mask) against its plain
          version at n=1500, d=128 with the KNN mask (k=25, no self loops)
          of the port's knn, at n=300, and with a fixed eps: max |diff|
          <= 1e-6, CUDA-event times and the reckoned bound (no path calls
          K3);
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

then the ``kernels`` line, the card's name and power limit as nvidia-smi
prints them, and the final ``{"ok": true, ...}`` line.  Any failed check
raises, and the script exits non-zero without the final line.
"""
from __future__ import annotations

import json
import math
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
# H100 SXM peaks from NVIDIA's data sheet, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# kernel-name substrings that sort the profile's device time into groups;
# the first group that matches takes the kernel
PROFILE_GROUPS = (
    ("k1_affinity", ("affinity_sym",)),
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
    ("k2_knn", ("knn_topk", "sqnorm")),
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


def k1_bound_ms(n: int, d: int) -> tuple[float, str]:
    """Least time for K1's work: x, eps and M read once, W written once;
    W is symmetric, so the dot products need only the Gram matrix's upper
    triangle, n (n + 1) d f32 operations."""
    nbytes = 4 * (n * d + n + n * n) + 4 * n * n
    ops = n * (n + 1) * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def k2_bound_ms(n: int, d: int, k: int) -> tuple[float, str]:
    """Least time for K2's work: d2 is symmetric, so the dot products need
    only the Gram matrix's upper triangle, n (n + 1) / 2 d FMA of two f32
    operations each, against x read once and nbr (int64) and dist2 written
    once."""
    nbytes = 4 * n * d + (8 + 4) * n * k
    ops = n * (n + 1) * d
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
    built = _build.build("affinity_sym", "knn_topk")
    wall = time.perf_counter() - t0
    for name, result in built.items():
        seconds, log = result if result is not None else (None, "")
        emit("build", source=f"{name}.cu", wall_s=round(wall, 3),
             compiled=result is not None, nvcc_s=seconds,
             nvcc_flags=list(_build.NVCC_FLAGS),
             ptxas=[ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "smem" in ln or "spill" in ln])


def phase_k1():
    import torch

    from graphlearninglayer_tpu_torch.ops.dense_mode import build_dense_graph
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1

    dev = torch.device("cuda")
    result = {}
    for n in (1500, 300):
        x, _ = normalized_features(n, 128, SEED + n)
        x = x.to(dev)
        g = build_dense_graph(x, K)
        args = (x, g.eps, g.m_raw)
        got = k1.fused_affinity_sym(*args)
        want = k1.fused_affinity_sym_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= K1_TOL, f"K1 max |kernel - plain| {err} <= {K1_TOL} "
              f"at n={n}")
        ms = cuda_ms(lambda: k1.fused_affinity_sym(*args))
        plain_ms = cuda_ms(lambda: k1.fused_affinity_sym_plain(*args))
        bound_ms, bound_by = k1_bound_ms(n, 128)
        emit("k1", n=n, d=128, k=K, max_abs_err=err, tol=K1_TOL, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             edges=int(torch.maximum(g.m_raw, g.m_raw.T).sum().item()))
        result[n] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
    return result


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
        edge = pd[:, k]                       # the plain (k+1)-th distance
        pn, pd = pn[:, :k], pd[:, :k]
        err = (dist2 - pd).abs().max().item()
        band = 2.0 * err
        gap = edge - pd[:, k - 1]
        tie = gap <= band
        differ = ~(torch.sort(nbr, 1).values
                   == torch.sort(pn, 1).values).all(1)
        rows = differ.nonzero().squeeze(1).tolist()
        check(len(rows) <= K2_MAX_DIFFER * n,
              f"K2 neighbor sets differ on {len(rows)} of {n} rows")
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
        self_first = bool((nbr[:, 0] == torch.arange(n, device=dev)).all())
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
             tie_band=band, tie_rows=int(tie.sum()),
             tie_share=tie.float().mean().item(),
             tie_rows_rel_1e5=int((gap <= 1e-5 * pd[:, k - 1]).sum()),
             differing_rows=len(rows),
             differing_outside_ties=int((differ & ~tie).sum()),
             one_boundary_swap=one_boundary_swap, swap_gap_max=swap_gap,
             self_first=self_first, ms=ms, plain_ms=plain_ms,
             library_ms=library_ms,
             library="torch.cdist + torch.topk (two calls, full n x n)",
             bound_ms=bound_ms, bound_by=bound_by)
        check(self_first, f"K2 puts self first at n={n}")
        check(err <= K2_TOL, f"K2 max |dist2 diff| {err} <= {K2_TOL}")
        check(not bool((differ & ~tie).any()),
              f"K2 neighbor sets equal the plain ones outside the tie set "
              f"at n={n}")
        check(one_boundary_swap, f"K2's differing rows each swap exactly "
              f"one neighbor at the boundary at n={n} ({swap_gap} > {band})")
        result[n] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        del x, nbr, dist2, pn, pd, edge, gap
    torch.cuda.empty_cache()
    return result


def phase_op():
    import torch

    from graphlearninglayer_tpu_torch.ops import laplace_learning
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1

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


def phase_profile(state, step, data, rng, steps=3):
    """Where a warm f32 train step (TF32 off) spends device time."""
    import torch

    images, labels = data
    torch.backends.cudnn.allow_tf32 = False
    batches = iter([rng.permutation(len(images))[:N_BASE + N_BATCH]
                    for _ in range(steps)])

    def run():
        idx = next(batches)
        b, t = idx[:N_BASE], idx[N_BASE:]
        step(state, images[b], labels[b], images[t], labels[t])

    emit("profile", steps=steps, cudnn_tf32=False, matmul_tf32=False,
         **profile_window(run, steps))


def phase_train():
    """The training main path; returns K1's launches in it, the float32
    state it trained and the TF32 run's median ms per step."""
    import numpy as np
    import torch

    from graphlearninglayer_tpu_torch.data import (CHANNEL_STATS,
                                                   synthetic_dataset)
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
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
    phase_profile(f32_state, f32_step, data, rng)
    return launches, f32_state, tf32_ms


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


def phase_transductive_eval(state):
    """The eval main path; returns K2's launches in it."""
    import numpy as np
    import torch

    from graphlearninglayer_tpu_torch.data import (CHANNEL_STATS,
                                                   synthetic_dataset)
    from graphlearninglayer_tpu_torch.evalx import test_gl_transductive
    from graphlearninglayer_tpu_torch.ops import EvalGraphCache
    from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
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
    from graphlearninglayer_tpu_torch.ops.knn import knn

    dev = torch.device("cuda")
    result, errs = {}, []
    k3.fused_affinity.launches = 0
    for n, eps_mode in ((1500, "auto"), (300, "auto"), (1500, "fixed")):
        x, _ = normalized_features(n, 128, SEED + 3 * n)
        x = x.to(dev)
        nbr, d2 = knn(x, K)
        knn_mask = torch.zeros((n, n), device=dev).scatter_(1, nbr, 1.0)
        mask = knn_mask.fill_diagonal_(0.0).contiguous()
        eps = (torch.sqrt(d2[:, -1]).clamp_min(1e-6) if eps_mode == "auto"
               else torch.full((n,), 1.5, device=dev))
        args = (x, eps.contiguous(), mask)
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
        ms = cuda_ms(lambda: k3.fused_affinity(*args))
        plain_ms = cuda_ms(lambda: k3.fused_affinity_plain(*args))
        k3.fused_affinity.launches = launches   # only checked calls count
        bound_ms, bound_by = k1_bound_ms(n, 128)
        emit("k3", n=n, d=128, k=K, eps=eps_mode, max_abs_err=err,
             tol=K3_TOL, max_abs_err_with_self_loops=err_self, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=None,
             library="none: no single PyTorch call computes it")
        if n == 1500 and eps_mode == "auto":
            result = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
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
    return dict(k1_launches=k1_launches, k2_launches=k2_launches)


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
    k1_launches, state, tf32_ms = phase_train()
    phase_parity()
    phase_solve()
    phase_solve_parity()
    k2_launches = phase_transductive_eval(state)
    del state
    torch.cuda.empty_cache()
    k3_stats = phase_k3()
    phase_op_edge()
    phase_fullysup(tf32_ms)
    k1_main, k2_main = k1_stats[1500], k2_stats[EVAL_N]
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
