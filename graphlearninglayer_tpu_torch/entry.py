"""Entry points: the flagship forward and the multi-device dry run.

Twin of ``__graft_entry__.py``:

``entry()``             the forward step of the flagship model: a ResNet-18
                        BuildNet encoder (mlp head, 128-d features) and the
                        graph Laplace head, at the reference's default
                        250 base + 1250 batch nodes.  At that shape the op
                        runs in dense mode, so on the card kernel K1
                        launches once a forward.
``dryrun_multichip(n)`` the multi-device health check over n ranks: the
                        FullySup driver on the mesh (the edge-sharded eval,
                        then ``--device_data``), the row- and edge-sharded
                        transductive solves held to each other, and one
                        FGSM attack with its rows sharded over the ranks,
                        all at tiny shapes.

Where the JAX dry run places one program's inputs on n devices, the port
spawns n processes that form one process group (``parallel.spawn_ranks``):
over NCCL when each rank has a card of its own, over gloo when ranks share
a card, and over gloo on the CPU when the caller passes ``device="cpu"``
(the tests).  All three parts run in one world.

Run the forward on the card (``--dev cpu`` for the CPU):

    python -m graphlearninglayer_tpu_torch.entry

It builds the kernels, runs ``forward`` once, waits for the card, checks
that the scores are finite and prints their shape and the card's name.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .models import BuildNet, init_weights, l2_normalize
from .ops import laplace_learning
from .train.trainer import resolve_device

__all__ = ["entry", "dryrun_multichip", "main"]


def entry(device="cuda", base_n: int = 250, batch_n: int = 1250,
          num_classes: int = 10, dtype: torch.dtype = torch.float32,
          seed: int = 0):
    """``(forward, (model, images, base_labels))``.

    ``forward(model, images, base_labels)`` is the eval-mode BuildNet
    (``resnet18``, mlp head, 128-d features) followed by
    ``laplace_learning(feats, onehot(base_labels), tau=0.07,
    epsilon="auto", k=25)``: the (batch_n, num_classes) scores of the batch
    rows.  The arguments live on ``device`` in ``dtype``: the model's
    weights drawn from a generator seeded with ``seed``, then NCHW
    32x32x3 images from the same generator, and ``base_labels =
    arange(num_classes)`` repeated ``base_n // num_classes`` times.  The
    draws are float32 on the CPU whatever ``device`` and ``dtype``, so a
    float64 CPU call holds the float32 card call's inputs exactly."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = BuildNet("resnet18", head="mlp", feat_dim=128,
                     num_classes=num_classes, generator=gen)
    model = model.to(dev, dtype).eval()
    images = torch.randn((base_n + batch_n, 3, 32, 32),
                         generator=gen).to(dev, dtype)
    base_labels = torch.arange(num_classes).repeat(
        base_n // num_classes).to(dev)

    def forward(model, images, base_labels):
        with torch.no_grad():
            _, feats = model(images)
            y = F.one_hot(base_labels, num_classes).to(feats.dtype)
            return laplace_learning(feats, y, tau=0.07, epsilon="auto",
                                    k=25)

    return forward, (model, images, base_labels)


class DryrunCNN(nn.Module):
    """The dry run's feature trunk for BuildNet (``dryruncnn``): a
    stride-2 conv to 8 channels, ReLU, BatchNorm, a mean pool and a dense
    layer to 16 features (``__graft_entry__.py``'s ``FeatEncoder``)."""

    def __init__(self, in_channel: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_channel, 8, 3, stride=2, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.dense = nn.Linear(8, 16)

    def forward(self, x):
        x = self.bn(torch.relu(self.conv(x)))
        return self.dense(x.mean(dim=(2, 3)))


class SmallEncoder(nn.Module):
    """The dry run's attack network (``__graft_entry__.py``'s
    ``SmallEncoder``): two stride-2 convs (8 and 16 channels) with a
    BatchNorm after the first, a mean pool, 16 features; returns
    ``(softmax(dense(features)), l2-normalized features)``."""

    def __init__(self, num_classes: int, in_channel: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channel, 8, 3, stride=2, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.conv2 = nn.Conv2d(8, 16, 3, stride=2, padding=1)
        self.feat = nn.Linear(16, 16)
        self.head = nn.Linear(16, num_classes)

    def forward(self, x):
        x = self.bn(torch.relu(self.conv1(x)))
        x = torch.relu(self.conv2(x)).mean(dim=(2, 3))
        feat = self.feat(x)
        return torch.softmax(self.head(feat), dim=1), l2_normalize(feat)


def dryrun_draws(n_devices: int, num_classes: int = 4) -> dict:
    """The dry run's data, drawn in the JAX dry run's order from one numpy
    generator (seed 0), as CPU tensors: the attack's 2n base and 4n batch
    16x16x1 images (NCHW) and labels, and the solves' 32n nodes of 8
    dims with one-hot labels of their first 4n."""
    rng = np.random.default_rng(0)

    def nchw(size):
        return torch.from_numpy(rng.normal(size=size).astype(
            np.float32).transpose(0, 3, 1, 2).copy())

    d = dict(base_images=nchw((2 * n_devices, 16, 16, 1)),
             base_labels=torch.from_numpy(rng.integers(0, num_classes,
                                                       2 * n_devices)),
             images=nchw((4 * n_devices, 16, 16, 1)),
             labels=torch.from_numpy(rng.integers(0, num_classes,
                                                  4 * n_devices)))
    d["x_nodes"] = torch.from_numpy(rng.normal(
        size=(32 * n_devices, 8)).astype(np.float32))
    d["y_lab"] = F.one_hot(torch.from_numpy(rng.integers(
        0, num_classes, 4 * n_devices)), num_classes).float()
    return d


def attack_network(num_classes: int = 4) -> SmallEncoder:
    """The dry run's attack network in eval mode on the CPU, its weights
    from one seed (the same on every rank)."""
    model = SmallEncoder(num_classes)
    init_weights(model, torch.Generator().manual_seed(0))
    return model.eval()


def _launches() -> tuple[int, int]:
    from .ops.kernels import affinity, knn_topk

    return affinity.fused_affinity_sym.launches, knn_topk.fused_knn.launches


def _driver_argv(n: int, device: str) -> list[str]:
    return ["--dev", device, "--sup_train_type", "gl",
            "--dataset", "synthetic", "--model", "dryruncnn",
            "--epochs", "1", "--batch_size", str(4 * n),
            "--num_train", "10", "--knn_k", "6",
            "--synth_n_train", str(12 * n), "--synth_n_test", str(4 * n),
            "--num_workers", "0", "--plot_freq_ss", "100",
            "--epsilon", "auto", "--mesh", "auto", "--grad_warn", "0",
            # rank 0's 2-d feature plot is host work outside the check
            "--viz_max_n", "0"]


def _dryrun_rank(n_devices: int) -> dict:
    """One rank's dry run (``spawn_ranks`` runs it in each process of the
    world).  Returns the rank's backend, device, the driver runs' losses
    and accuracies, the seconds and the K1 / K2 launches of each part."""
    from .config.cli import parse_option
    from .models import buildnet
    from .parallel import (edge_sharded_transductive_laplace, make_mesh,
                           sharded_transductive_laplace)
    from .attack import make_sharded_gl_fast_gradient_attack
    from .train import fullysup

    mesh = make_mesh(n_devices, axes=("data", "graph"))
    dev = mesh.device
    print(f"dryrun rank {mesh.rank} of {mesh.size}: {mesh.backend} on "
          f"{dev}", flush=True)
    out = {"rank": mesh.rank, "backend": mesh.backend, "device": str(dev),
           "seconds": {}, "k1_launches": {}, "k2_launches": {}}

    def part(name, t0, before):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["seconds"][name] = time.perf_counter() - t0
        k1, k2 = _launches()
        out["k1_launches"][name] = k1 - before[0]
        out["k2_launches"][name] = k2 - before[1]

    num_classes, k = 4, 4

    # 1. the FullySup driver on the mesh: under this already-formed group
    #    run_training trains each step sharded over the ranks (--mesh auto,
    #    a launcher's route) and, with --shard_eval_min_n 1, evaluates
    #    through the edge-partitioned solve; then the device-resident
    #    configuration (--device_data).  --grad_warn 0: the random-ish dry
    #    run trips the reference's ||dX|| > 10 warning.  The encoder is
    #    registered in this process's model_dict for the dry run alone.
    argv = _driver_argv(n_devices, dev.type)
    t0, before = time.perf_counter(), _launches()
    buildnet.model_dict["dryruncnn"] = (DryrunCNN, 16)
    home = os.getcwd()
    try:
        with tempfile.TemporaryDirectory(prefix="gll_dryrun_") as work:
            os.chdir(work)
            try:
                records = fullysup.run_training(parse_option(
                    argv + ["--shard_eval_min_n", "1"]))
                records_dd = fullysup.run_training(parse_option(
                    argv + ["--device_data", "--augment_type_sup", "weak"]))
            finally:
                os.chdir(home)
    finally:
        buildnet.model_dict.pop("dryruncnn", None)
    part("driver", t0, before)
    if not (records["loss"] and np.isfinite(records["loss"][0])):
        raise RuntimeError("multichip driver dry run produced non-finite "
                           "loss")
    if not all(np.isfinite(a) for a in records["test_acc"]):
        raise RuntimeError("multichip driver dry run produced non-finite "
                           "eval accuracy")
    if not (records_dd["loss"] and np.isfinite(records_dd["loss"][0])):
        raise RuntimeError("multichip device-data driver dry run produced "
                           "non-finite loss")
    out.update(loss=records["loss"], test_acc=records["test_acc"],
               eval_routes=[e["route"] for e in records["eval"]],
               loss_device_data=records_dd["loss"])

    d = dryrun_draws(n_devices, num_classes)
    # 2. the sharded transductive solve in both distributed forms: the
    #    row-sharded CG (iterate all-gathered a matvec) and the edge-
    #    partitioned halo exchange (cluster-sharded KNN build, an
    #    all-to-all a matvec)
    t0, before = time.perf_counter(), _launches()
    gmesh = make_mesh(n_devices, axes=("graph",))
    x_nodes, y_lab = d["x_nodes"].to(dev), d["y_lab"].to(dev)
    kw = dict(knn_num=6, epsilon="auto", tau=1e-8, knn_block=32)
    sol_row = sharded_transductive_laplace(gmesh, x_nodes, y_lab, **kw)
    sol_edge = edge_sharded_transductive_laplace(gmesh, x_nodes, y_lab, **kw)
    part("solves", t0, before)
    if not (bool(torch.isfinite(sol_row).all())
            and bool(torch.isfinite(sol_edge).all())):
        raise RuntimeError("multichip sharded solves produced non-finite "
                           "scores")
    apart = (sol_edge - sol_row).abs().max().item()
    out["solves_max_abs_diff"] = apart
    if not apart <= 1e-4:
        raise RuntimeError(f"edge- and row-sharded solves differ by {apart} "
                           f"> 1e-4")

    # 3. one FGSM attack through the graph op with the base and batch rows
    #    sharded over the ranks; the encoder's weights come from one seed,
    #    the same on every rank
    t0, before = time.perf_counter(), _launches()
    model = attack_network(num_classes).to(dev)

    def encode(x):
        return model(x)[1]

    attack = make_sharded_gl_fast_gradient_attack(
        encode, num_classes, mesh, tau=0.0, epsilon_graph="auto", k=k,
        grad_warn=None)
    images, labels = d["images"], d["labels"]
    adv, adv_pred = attack(d["base_images"], d["base_labels"], images,
                           labels, eps=0.05, kind="fgsm", min_val=-3.0,
                           max_val=3.0)
    part("attack", t0, before)
    if not bool(torch.isfinite(adv).all()):
        raise RuntimeError("multichip sharded FGSM produced non-finite "
                           "images")
    if adv.shape != images.shape or adv_pred.shape != labels.shape:
        raise RuntimeError(f"multichip sharded FGSM shapes {adv.shape}, "
                           f"{adv_pred.shape}")
    out["attack_max_step"] = (adv.cpu() - images).abs().max().item()
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> list[dict]:
    """The multi-device dry run over ``n_devices`` spawned ranks, which
    form one process group.  ``device``: "cuda" (rank r on card r %
    device_count: NCCL with a card a rank, gloo where ranks share one) or
    "cpu" (gloo CPU ranks, for the tests).  A failed check on any rank
    raises here with that rank's traceback.  Returns each rank's summary
    (see ``_dryrun_rank``) in rank order."""
    from .parallel import spawn_ranks

    dev = resolve_device(device)
    threads = (max(1, torch.get_num_threads() // n_devices)
               if dev.type == "cpu" else None)
    return spawn_ranks(_dryrun_rank, n_devices, (n_devices,),
                       device=dev.type, threads=threads)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Run the flagship forward (entry()) once.")
    parser.add_argument("--dev", default="cuda", choices=["cuda", "cpu"],
                        help="torch device: cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --dev cpu to run on "
                           "the CPU")
    dev = torch.device(args.dev)
    if dev.type == "cuda":
        from .ops.kernels import _build

        _build.build("affinity_sym", "knn_topk")
    forward, fargs = entry(device=dev)
    t0 = time.perf_counter()
    scores = forward(*fargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    if not bool(torch.isfinite(scores).all()):
        raise RuntimeError("entry() gave non-finite scores")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"entry() ran OK: scores {tuple(scores.shape)} on {where} "
          f"(first call {seconds:.3f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
