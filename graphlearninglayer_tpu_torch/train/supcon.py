"""Supervised-contrastive / SimCLR encoder pretraining.

Twin of ``graphlearninglayer_tpu/train/supcon.py``: two independently
augmented views of each batch through the BuildNet encoder and head, the
SupCon loss on the unit features (with labels for SupCon, without for
SimCLR), one optimizer update a step.  The views come from the host
``TwoCropBatchLoader``, or, with ``--device_data``, from the uint8 training
set on the device: each step sends one index vector, gathers its rows and
augments them twice there (``data/device_aug.py``).  Either way view v of
image i is row ``2 * i + v`` of the encoded batch.  The checkpoint goes to
``<save_folder>/supcon`` (``utils/checkpoint.py``).

Run on the card (the default) or, with ``--dev cpu``, on the CPU:

    python -m graphlearninglayer_tpu_torch.train.supcon --dataset synthetic \\
        --batch_size 128 --epochs 2 --sup_method SupCon [--device_data]

``--sup_method SupCon`` trains SupCon; any other value trains SimCLR.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config.cli import parse_option
from ..data import (CHANNEL_STATS, Transform, TwoCropBatchLoader,
                    load_dataset, synth_kwargs_from_opt)
from ..data.device_aug import DeviceTransform
from ..models import BuildNet
from ..utils.checkpoint import save_checkpoint
from .losses import sup_con_loss
from .optim import make_lr_schedule
from .trainer import (TrainState, _device_normalize, _to_device,
                      _zero_grads, create_train_state, resolve_device)

__all__ = ["run_supcon", "main", "make_supcon_step", "device_views"]


def make_supcon_step(temperature: float, simclr: bool = False, norm=None,
                     device="cuda"):
    """``step(state, views, labels)`` -> ``(state, loss)``: one SupCon (or,
    with ``simclr``, SimCLR) update on ``views``, a (B, n_views, H, W, C)
    uint8 batch, normalized on the device with ``norm=(mean, std)``.
    ``loss`` stays a device scalar."""
    dev = resolve_device(device)

    def step(state: TrainState, views, labels):
        model = state.model
        model.train()
        views = _to_device(views, dev)
        bsz, n_views = views.shape[:2]
        x = _device_normalize(views.reshape(bsz * n_views, *views.shape[2:]),
                              norm)
        _, feats = model(x.to(next(model.parameters()).dtype))
        loss = sup_con_loss(
            feats.reshape(bsz, n_views, -1),
            None if simclr else _to_device(labels, dev).long(),
            temperature=temperature)
        _zero_grads(model)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, loss.detach()

    return step


def device_views(aug: DeviceTransform, data: torch.Tensor,
                 idx: torch.Tensor, image_shape, generator=None,
                 n_views: int = 2) -> torch.Tensor:
    """``n_views`` independently augmented copies of the resident rows
    ``idx`` of ``data`` (N, H*W*C), as a (B, n_views, H, W, C) uint8
    batch: view v of image i at [i, v], the ``TwoCropBatchLoader``
    layout."""
    images = data.index_select(0, idx).reshape(-1, *image_shape)
    return torch.stack([aug(images, generator) for _ in range(n_views)],
                       dim=1)


def run_supcon(opt, simclr: bool = False) -> dict:
    """Pretrain the encoder with SupCon (or SimCLR).  Returns the records:
    per-epoch ``loss`` and ``epoch_s`` (ending in a device sync), and
    ``steps_per_epoch``."""
    if opt.dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --dev cpu to run on "
                           "the CPU")
    dev = resolve_device(opt.dev)
    spec = load_dataset(opt.dataset, allow_synthetic_fallback=True,
                        **synth_kwargs_from_opt(opt))
    tf = Transform(spec.name if spec.name in CHANNEL_STATS else "synthetic",
                   opt.augment_type_ss if opt.augment_type_ss != "no"
                   else "weak")
    n_train = len(spec.train_labels)
    steps_per_epoch = n_train // opt.batch_size
    model = BuildNet(name=opt.model, head=opt.head_type,
                     feat_dim=opt.embedding_dim,
                     num_classes=spec.num_classes,
                     dtype=torch.bfloat16 if opt.bf16 else torch.float32,
                     generator=torch.Generator().manual_seed(opt.seed),
                     in_channel=spec.image_shape[-1])
    schedule = make_lr_schedule(opt.learning_rate, opt.epochs,
                                steps_per_epoch, cosine=opt.cosine,
                                lr_decay_rate=opt.lr_decay_rate,
                                lr_decay_epochs=opt.lr_decay_epochs,
                                warm=opt.warm)
    state = create_train_state(model, schedule, device=dev, adam=opt.Adam,
                               momentum=opt.momentum,
                               weight_decay=opt.weight_decay)
    step = make_supcon_step(opt.temp, simclr, norm=(tf.mean, tf.std),
                            device=dev)

    device_data = bool(getattr(opt, "device_data", False))
    loader = None
    if device_data:
        data_dev = torch.from_numpy(np.ascontiguousarray(
            spec.train_images.reshape(n_train, -1))).to(dev)
        aug = DeviceTransform(tf.dataset, tf.mode)
        gen = torch.Generator(device=dev).manual_seed(opt.seed)
        rng_order = np.random.default_rng(opt.seed * 7919 + 5)
    else:
        loader = TwoCropBatchLoader(
            spec.train_images, spec.train_labels, opt.batch_size, tf,
            seed=opt.seed, workers=opt.num_workers, n_views=2, emit="uint8",
            to_device=dev)

    def stream():
        if loader is not None:
            for _, views, labels in loader:
                yield views, labels
            return
        order = rng_order.permutation(n_train)
        for i in range(steps_per_epoch):
            idx = order[i * opt.batch_size:(i + 1) * opt.batch_size]
            yield (device_views(aug, data_dev, _to_device(idx, dev),
                                spec.image_shape, gen),
                   spec.train_labels[idx])

    records = {"loss": [], "epoch_s": [], "steps_per_epoch": steps_per_epoch}
    try:
        for epoch in range(1, opt.epochs + 1):
            t0 = time.time()
            losses = []
            for views, labels in stream():
                state, loss = step(state, views, labels)
                losses.append(loss)
            # one copy an epoch; reading each loss would sync every step
            records["loss"].append(float(torch.stack(losses).double()
                                         .mean()))
            records["epoch_s"].append(time.time() - t0)
            print(f"supcon epoch {epoch}: loss {records['loss'][-1]:.4f} "
                  f"({records['epoch_s'][-1]:.1f}s)")
    finally:
        if loader is not None:
            loader.close()
    save_checkpoint(os.path.join(opt.save_folder, "supcon"), state,
                    opt.epochs, opt)
    return records


def main(argv=None):
    opt = parse_option(argv)
    return run_supcon(opt, simclr=(opt.sup_method != "SupCon"))


if __name__ == "__main__":
    main()
