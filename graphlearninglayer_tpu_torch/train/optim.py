"""Optimizers and LR schedules.

Twin of ``graphlearninglayer_tpu/train/optim.py``.

The reference adjusts the LR once per *epoch* (cosine to eta_min =
lr*rate^3, or step decay at lr_decay_epochs) plus an optional per-batch
linear warmup over the first ``warm_epochs`` epochs.  Here the schedule is a
function of the global step (``steps_per_epoch`` supplied), applied by a
``LambdaLR`` that is stepped once after every optimizer step.  Weight decay
is coupled, as in ``torch.optim.SGD(weight_decay=...)``: added to the
gradient before momentum, which is what the JAX package's
``add_decayed_weights -> trace -> scale_by_learning_rate`` chain does.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence

import torch

__all__ = ["make_lr_schedule", "make_optimizer"]


def make_lr_schedule(learning_rate: float, epochs: int, steps_per_epoch: int,
                     cosine: bool = True, lr_decay_rate: float = 0.1,
                     lr_decay_epochs: Sequence[int] = (700, 800, 900),
                     warm: bool = False, warm_epochs: int = 10,
                     warmup_from: float = 0.01,
                     warmup_to: float | None = None) -> Callable[[int], float]:
    """Step-indexed LR schedule ``step -> lr`` (step 0 is the first update).

    Epoch-granular decay: the decayed LR is computed from the (1-based) epoch
    number and held constant within the epoch, exactly as the reference
    does."""
    eta_min = learning_rate * lr_decay_rate ** 3
    if warmup_to is None:
        if cosine:
            warmup_to = eta_min + (learning_rate - eta_min) * (
                1 + math.cos(math.pi * warm_epochs / epochs)) / 2
        else:
            warmup_to = learning_rate
    decay_epochs = tuple(lr_decay_epochs)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch + 1  # reference epochs are 1-based
        batch_id = step % steps_per_epoch
        if cosine:
            lr = eta_min + (learning_rate - eta_min) * (
                1 + math.cos(math.pi * epoch / epochs)) / 2
        else:
            lr = learning_rate * lr_decay_rate ** sum(
                epoch > e for e in decay_epochs)
        if warm and epoch <= warm_epochs:
            p = (batch_id + (epoch - 1) * steps_per_epoch) / (
                warm_epochs * steps_per_epoch)
            lr = warmup_from + p * (warmup_to - warmup_from)
        return lr

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   schedule: Callable[[int], float], adam: bool = False,
                   momentum: float = 0.9, weight_decay: float = 5e-4):
    """SGD(momentum, wd) or Adam(wd), reference set_optimizer.

    Returns ``(optimizer, scheduler)``.  The optimizer's base LR is 1 and the
    ``LambdaLR`` multiplies it by ``schedule(step)``, so the rate of the n-th
    update (counting from 0) is exactly ``schedule(n)``, as with optax's
    step count.  Call ``scheduler.step()`` after each ``optimizer.step()``.
    """
    if adam:
        opt = torch.optim.Adam(params, lr=1.0, weight_decay=weight_decay)
    else:
        opt = torch.optim.SGD(params, lr=1.0, momentum=momentum, dampening=0,
                              weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)
