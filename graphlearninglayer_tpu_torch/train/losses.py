"""Loss functions: twin of ``graphlearninglayer_tpu/train/losses.py``.

``custom_ce_loss`` is the GL training loss: the graph layer's outputs are
already (approximately) row-stochastic scores, so cross-entropy is taken on
the raw scores with a log clamp and NO softmax.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["custom_ce_loss"]


def custom_ce_loss(scores: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """CE on probability-like scores: -sum(onehot * log(scores + 1e-8)) / B.
    ``targets`` are integer labels."""
    batch, num_classes = scores.shape
    onehot = F.one_hot(targets.long(), num_classes).to(scores.dtype)
    return -torch.sum(onehot * torch.log(scores + 1e-8)) / batch
