"""Backbone + projection head + aux classifier (the reference's ``buildnet``).

Twin of ``graphlearninglayer_tpu/models/buildnet.py``: an encoder from the
model registry, a 'linear' / 'mlp' / 'no' projection head to ``feat_dim``,
and an auxiliary MLP classifier (-> 32 -> num_classes, optional softmax).
The forward returns ``(pred, normalized_features)``: the GL head consumes
the unit-norm features, the MLP path consumes ``pred``.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn

from . import resnet as _resnet
from .cnn import l2_normalize

__all__ = ["BuildNet", "model_dict", "init_weights"]

# name -> (encoder constructor, feature dim).  Only the ResNet entries are
# ported so far.
model_dict: dict[str, tuple[Callable[..., nn.Module], int]] = {
    "resnet18": (_resnet.resnet18, 512),
    "resnet34": (_resnet.resnet34, 512),
    "resnet50": (_resnet.resnet50, 2048),
    "resnet101": (_resnet.resnet101, 2048),
}


class BuildNet(nn.Module):
    """Encoder -> head -> aux classifier; returns (pred, unit features).

    ``forward`` takes NCHW float input (PyTorch's habit; the JAX BuildNet
    takes NHWC).  ``dtype`` is the ENCODER compute dtype: bf16 runs the
    encoder under ``torch.autocast``, while parameters stay float32.  The
    projection head, the aux classifier and the L2 normalize always run in
    float32 and the features leave as float32, because the graph op needs
    full-precision distances.

    ``generator``: draw the initial weights from this generator (PyTorch's
    default initialization schemes) instead of the global one.
    """

    def __init__(self, name: str = "resnet18", head: str = "mlp",
                 feat_dim: int = 128, num_classes: int = 10,
                 softmax: bool = True, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        model_fn, dim_in = model_dict[name]
        self.encoder = model_fn()
        if head == "linear":
            self.head = nn.Linear(dim_in, feat_dim)
        elif head == "mlp":
            self.head = nn.Sequential(nn.Linear(dim_in, dim_in), nn.ReLU(),
                                      nn.Linear(dim_in, feat_dim))
        elif head == "no":
            self.head = nn.Identity()
            feat_dim = dim_in
        else:
            raise NotImplementedError(f"head not supported: {head}")
        # aux MLP classifier (named 'linear' so the MLP-head pretrain can
        # freeze everything else)
        self.linear = nn.Sequential(nn.Linear(feat_dim, 32), nn.ReLU(),
                                    nn.Linear(32, num_classes))
        self.softmax = softmax
        self.dtype = dtype
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x: torch.Tensor):
        with torch.autocast(device_type=x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            feat = self.encoder(x)
        feat = self.head(feat)
        pred = self.linear(feat)
        if self.softmax:
            pred = torch.softmax(pred, dim=1)
        return pred, l2_normalize(feat)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every conv and linear layer with PyTorch's default schemes
    (kaiming-uniform weights with a=sqrt(5), uniform biases) from
    ``generator``, and reset BatchNorm to weight 1, bias 0 and fresh
    running statistics."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                     generator=generator)
            if m.bias is not None:
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
