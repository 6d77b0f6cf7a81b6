#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

It drives the port's main path, FullySup GL training (ResNet-18 encoder, mlp
head, 128-d features, graph Laplace learning in dense mode, custom CE, SGD
with momentum and a cosine schedule), at the flagship's full width: 250 base
+ 1250 batch 32x32x3 uint8 images per step, 10 classes, k=25, tau=0.07,
eps='auto'.  Weights are random, drawn from a seeded generator; the images
come from the port's synthetic dataset.  Phases, one JSON line each:

  device  the card, its power limit, torch and CUDA versions;
  build   every CUDA kernel of the port, compiled from csrc/ with nvcc;
  k1      kernel K1 against its plain PyTorch version on the card at the
          op's shape (n=1500, d=128, k=25) and at n=300, max |diff| <= 1e-6,
          with CUDA-event times and the reckoned bound;
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
    built = _build.build("affinity_sym")
    wall = time.perf_counter() - t0
    seconds, log = built if built is not None else (None, "")
    emit("build", source="affinity_sym.cu", wall_s=round(wall, 3),
         compiled=built is not None, nvcc_s=seconds,
         nvcc_flags=list(_build.NVCC_FLAGS),
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "smem" in ln])


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
    emit("train", run=label, cudnn_tf32=cudnn_tf32, matmul_tf32=False,
         steps=steps,
         median_ms_per_step=statistics.median(times[1:]),
         first_step_ms=times[0], peak_mem_gib=peak, k1_launches=launches,
         first_loss=losses[0], last_loss=losses[-1])
    return state, step


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


def phase_profile(state, step, data, rng, steps=3):
    """Where a warm f32 train step (TF32 off) spends device time:
    torch.profiler over ``steps`` steps; kernel time by name and the
    device's busy share of the host-clock window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    images, labels = data
    torch.backends.cudnn.allow_tf32 = False
    batches = [rng.permutation(len(images))[:N_BASE + N_BATCH]
               for _ in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for idx in batches:
            b, t = idx[:N_BASE], idx[N_BASE:]
            step(state, images[b], labels[b], images[t], labels[t])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    groups: dict[str, float] = {}
    for name, t in by_name.items():
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + t
    emit("profile", steps=steps, cudnn_tf32=False, matmul_tf32=False,
         wall_ms_per_step=wall_us / 1e3 / steps,
         device_busy_ms_per_step=busy / 1e3 / steps,
         kernel_ms_per_step=total / 1e3 / steps,
         busy_share=busy / wall_us if kernels else "not measured",
         groups_ms_per_step={g: t / 1e3 / steps for g, t in
                             sorted(groups.items(), key=lambda kv: -kv[1])},
         top_kernels=[{"name": n[:90], "ms_per_step": t / 1e3 / steps,
                       "share": t / total} for n, t in top])


def phase_train():
    """The main path; returns K1's launches in it."""
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
    f32_state, f32_step = _train_run("f32", torch.float32, False, F32_STEPS,
                                     data, rng)
    _train_run("tf32", torch.float32, True, TF32_STEPS, data, rng)
    state, _ = _train_run("bf16", torch.bfloat16, False, BF16_STEPS, data,
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
    return launches


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
    phase_op()
    launches = phase_train()
    phase_parity()
    main_shape = k1_stats[1500]
    kernels = [{
        "name": "fused_affinity_sym",
        "route": "cuda",
        "source": "graphlearninglayer_tpu_torch/ops/kernels/csrc/"
                  "affinity_sym.cu",
        "replaces": "graphlearninglayer_tpu/ops/kernels/affinity.py:49",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in k1_stats.values()),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
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
