"""Seeded re-initialization of a model's layers."""
from __future__ import annotations

import math

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

__all__ = ["init_weights"]


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every conv and linear layer with PyTorch's default schemes
    (kaiming-uniform weights with a=sqrt(5), uniform biases) from
    ``generator``, and reset BatchNorm to weight 1, bias 0 and fresh
    running statistics.  A weight-normed conv gets its direction v drawn
    so, and its gain g = ||v|| per output channel, so that w = v, as at
    ``weight_norm``'s registration."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if parametrize.is_parametrized(m, "weight"):
                p = m.parametrizations.weight
                nn.init.kaiming_uniform_(p.original1, a=math.sqrt(5),
                                         generator=generator)
                p.original0.copy_(torch.linalg.vector_norm(
                    p.original1, dim=tuple(range(1, p.original1.dim())),
                    keepdim=True))
            else:
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                         generator=generator)
            if m.bias is not None:
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
