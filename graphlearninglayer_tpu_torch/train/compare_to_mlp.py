"""MLP-vs-GL comparison driver.

Twin of ``graphlearninglayer_tpu/train/compare_to_mlp.py``: it trains the
MLP classifier head and, on every batch, also evaluates the loss the GL
head would have on the same augmented batch, without training it (dual
loss meters and dual plots).  The GL loss comes from the parameters and the
BatchNorm statistics before the batch's update, as JAX's step computes it:
the eval-mode forward runs under ``no_grad`` before the MLP head's
train-mode forward and optimizer step.  Records go to
``compare_records.npy``; the plot is best-effort.

Run on the card (the default) or, with ``--dev cpu``, on the CPU:

    python -m graphlearninglayer_tpu_torch.train.compare_to_mlp \\
        --dataset synthetic --batch_size 128 --epochs 3
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..config.cli import parse_option
from ..data import (CHANNEL_STATS, BatchLoader, ScoredDataset, Transform,
                    load_dataset, synth_kwargs_from_opt)
from ..models import BuildNet
from ..ops import laplace_learning
from .losses import custom_ce_loss
from .optim import make_lr_schedule
from .trainer import (TrainState, _device_normalize, _mlp_update,
                      _to_device, create_train_state, resolve_device)

__all__ = ["run_comparison", "main", "make_compare_step"]


def make_compare_step(num_classes: int, base_x, base_labels, tau: float,
                      epsilon="auto", k: int = 25, norm=None,
                      device="cuda"):
    """``step(state, images, labels)`` -> ``(state, mlp_loss, gl_loss)``:
    the GL loss of ``images`` (uint8 NHWC, normalized on the device with
    ``norm``) against the base set ``base_x`` (normalized float NHWC) with
    ``base_labels``, from the current parameters in eval mode, then one
    MLP-head update on the same batch.  Both losses stay device scalars."""
    dev = resolve_device(device)
    base = _device_normalize(_to_device(base_x, dev), None)
    y = F.one_hot(_to_device(base_labels, dev).long(), num_classes)

    def step(state: TrainState, images, labels):
        model = state.model
        labels = _to_device(labels, dev).long()
        x = _device_normalize(_to_device(images, dev), norm)
        model.eval()
        with torch.no_grad():
            _, feats = model(torch.cat([base, x]).to(
                next(model.parameters()).dtype))
            gl_pred = laplace_learning(feats, y.to(feats.dtype), tau=tau,
                                       epsilon=epsilon, k=k)
            gl_loss = custom_ce_loss(gl_pred, labels)
        state, metrics = _mlp_update(state, x, labels)
        return state, metrics["loss"], gl_loss

    return step


def run_comparison(opt) -> dict:
    """Train the MLP head for ``opt.epochs`` and meter both heads' losses.
    Returns the records: per-epoch ``mlp_loss``, ``gl_loss`` and
    ``epoch_s`` (ending in a device sync), and ``steps_per_epoch``."""
    if opt.dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --dev cpu to run on "
                           "the CPU")
    dev = resolve_device(opt.dev)
    rng_np = np.random.default_rng(opt.seed)
    spec = load_dataset(opt.dataset, allow_synthetic_fallback=True,
                        **synth_kwargs_from_opt(opt))
    tf = Transform(spec.name if spec.name in CHANNEL_STATS else "synthetic",
                   "eval" if opt.augment_type_sup == "no"
                   else opt.augment_type_sup)
    loader = BatchLoader(spec.train_images, spec.train_labels,
                         opt.batch_size, tf, seed=opt.seed,
                         workers=opt.num_workers, emit="uint8",
                         to_device=dev)
    model = BuildNet(name=opt.model, head=opt.head_type,
                     feat_dim=opt.embedding_dim,
                     num_classes=spec.num_classes,
                     softmax=not opt.no_softmax,
                     dtype=torch.bfloat16 if opt.bf16 else torch.float32,
                     generator=torch.Generator().manual_seed(opt.seed),
                     in_channel=spec.image_shape[-1])
    schedule = make_lr_schedule(opt.learning_rate, opt.epochs, len(loader),
                                cosine=opt.cosine,
                                lr_decay_rate=opt.lr_decay_rate,
                                lr_decay_epochs=opt.lr_decay_epochs)
    state = create_train_state(model, schedule, device=dev, adam=opt.Adam,
                               momentum=opt.momentum,
                               weight_decay=opt.weight_decay)
    base_imgs, base_labels = ScoredDataset(spec).select_base(
        opt.num_train, "random", rng_np)
    step = make_compare_step(
        spec.num_classes, Transform(tf.dataset, "eval").normalize(base_imgs),
        base_labels, tau=opt.temp, epsilon=opt.epsilon, k=opt.knn_k,
        norm=(tf.mean, tf.std), device=dev)

    records = {"mlp_loss": [], "gl_loss": [], "epoch_s": [],
               "steps_per_epoch": len(loader)}
    try:
        for epoch in range(1, opt.epochs + 1):
            t0 = time.time()
            mlp_m, gl_m = [], []
            for _, images, labels in loader:
                state, mlp_loss, gl_loss = step(state, images, labels)
                mlp_m.append(mlp_loss)
                gl_m.append(gl_loss)
            # one copy an epoch; reading each loss would sync every step
            mlp, gl = torch.stack([torch.stack(mlp_m).double().mean(),
                                   torch.stack(gl_m).double().mean()]
                                  ).tolist()
            records["mlp_loss"].append(mlp)
            records["gl_loss"].append(gl)
            records["epoch_s"].append(time.time() - t0)
            print(f"epoch {epoch}: mlp loss {mlp:.4f}  gl loss {gl:.4f}  "
                  f"({records['epoch_s'][-1]:.1f}s)")
    finally:
        loader.close()

    np.save(os.path.join(opt.save_folder, "compare_records.npy"), records,
            allow_pickle=True)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.figure()
        plt.plot(records["mlp_loss"], label="mlp")
        plt.plot(records["gl_loss"], label="gl")
        plt.legend()
        plt.xlabel("epoch")
        plt.ylabel("loss")
        plt.savefig(os.path.join(opt.save_folder, "compare_losses.png"))
        plt.close()
    except Exception as e:  # plotting is best-effort observability
        print(f"plotting skipped: {e}")
    return records


def main(argv=None):
    return run_comparison(parse_option(argv))


if __name__ == "__main__":
    main()
