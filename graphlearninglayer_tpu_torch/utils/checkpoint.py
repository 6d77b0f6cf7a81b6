"""Checkpoints in the reference's torch layout, with a tolerant restore.

Twin of ``graphlearninglayer_tpu/utils/checkpoint.py`` and
``utils/torch_import.py``.  A checkpoint is one ``torch.save`` file per
epoch, ``<path>/ckpt_epoch_<epoch>.pth``, holding the reference's payload

    {'opt': dict of the CLI options, 'model': model state_dict,
     'optimizer': optimizer state_dict, 'epoch': epoch}

plus ``'step'`` (the optimizer updates taken), which marks a file the port
wrote.  :func:`restore_checkpoint` accepts such a directory or a single
``.pth``/``.pt`` file.  It strips ``module.`` prefixes (DataParallel
checkpoints), loads the model with ``strict=False`` and prints the missing
and unexpected keys, as the reference's tolerant load does.  The port's
``BuildNet`` keeps the reference's parameter names, so a checkpoint the
reference trained loads directly.  A file the port wrote also restores the
optimizer (momentum buffers) and the step, so the LR schedule continues; a
file from elsewhere restores the weights only, as the JAX package does.
"""
from __future__ import annotations

import argparse
import os
import re

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_state_dict_tolerant"]

_FILE = re.compile(r"ckpt_epoch_(\d+)\.pth$")


def _file(path: str, epoch: int) -> str:
    return os.path.join(path, f"ckpt_epoch_{epoch}.pth")


def save_checkpoint(path: str, state, epoch: int, opt=None) -> str:
    """Write ``state`` at ``epoch`` to ``<path>/ckpt_epoch_<epoch>.pth`` and
    return the file's path.  The file is written aside and renamed over the
    old one, so re-saving an epoch overwrites it and a failed write leaves
    the previous checkpoint intact."""
    os.makedirs(path, exist_ok=True)
    payload = {
        "opt": dict(vars(opt)) if opt is not None else {},
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "epoch": int(epoch),
        "step": int(state.step),
    }
    out = _file(path, epoch)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def latest_step(path: str) -> int | None:
    """The highest epoch saved under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    epochs = [int(m.group(1)) for f in os.listdir(path)
              if (m := _FILE.match(f))]
    return max(epochs) if epochs else None


def load_state_dict_tolerant(model: torch.nn.Module, state_dict: dict,
                             verbose: bool = True) -> dict:
    """Load ``state_dict`` into ``model`` the reference's tolerant way:
    ``module.`` prefixes stripped, ``strict=False``.  Returns
    ``{'loaded', 'missing', 'unexpected'}`` key lists: missing = model keys
    not provided, unexpected = keys with no destination or of another
    shape.  BatchNorm's ``num_batches_tracked`` counts are never reported
    (both frameworks use a fixed momentum, so the count is never read)."""
    sd = {k.replace(".module", "").removeprefix("module."): v
          for k, v in state_dict.items()}
    own = model.state_dict()
    keep, unexpected = {}, []
    for k, v in sd.items():
        if k not in own or tuple(own[k].shape) != tuple(v.shape):
            if not k.endswith("num_batches_tracked"):
                unexpected.append(k)
            continue
        keep[k] = v
    model.load_state_dict(keep, strict=False)
    missing = [k for k in own if k not in keep
               and not k.endswith("num_batches_tracked")]
    report = {"loaded": [k for k in keep
                         if not k.endswith("num_batches_tracked")],
              "missing": missing, "unexpected": unexpected}
    if verbose and (missing or unexpected):
        print("Missing keys:", missing)
        print("Unexpected keys:", unexpected)
    return report


def _seek(state, step: int) -> None:
    """Put the optimizer's LR where the schedule has it after ``step``
    updates, and the scheduler's position with it."""
    sched = state.scheduler
    sched.last_epoch = step
    lrs = [base * fn(step) for base, fn in zip(sched.base_lrs,
                                                sched.lr_lambdas)]
    for group, lr in zip(state.optimizer.param_groups, lrs):
        group["lr"] = lr
    sched._last_lr = lrs
    state.step = step


def restore_checkpoint(path: str, state, epoch: int | None = None):
    """Tolerant restore into ``state`` (a ``TrainState``); returns
    ``(state, restored_epoch)``.  ``path`` is a checkpoint directory (the
    latest epoch, or ``epoch``) or a ``.pth``/``.pt`` file."""
    if os.path.isfile(path):
        file = path
    else:
        if epoch is None:
            epoch = latest_step(path)
        if epoch is None or not os.path.isfile(_file(path, epoch)):
            raise FileNotFoundError(f"no checkpoint under {path}")
        file = _file(path, epoch)
    dev = next(state.model.parameters()).device
    # the reference pickles its argparse options into the payload
    with torch.serialization.safe_globals([argparse.Namespace]):
        d = torch.load(file, map_location=dev, weights_only=True)
    sd = d.get("model", d) if isinstance(d, dict) else d
    report = load_state_dict_tolerant(state.model, sd)
    ckpt_epoch = int(d.get("epoch", 0)) if isinstance(d, dict) else 0
    if isinstance(d, dict) and "step" in d:
        state.optimizer.load_state_dict(d["optimizer"])
        _seek(state, int(d["step"]))
    else:
        print(f"torch import: {len(report['loaded'])} tensors loaded from "
              f"{file}")
    return state, ckpt_epoch
