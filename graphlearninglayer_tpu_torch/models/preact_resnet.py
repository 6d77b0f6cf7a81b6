"""Pre-activation ResNets (torch.nn).

Twin of ``graphlearninglayer_tpu/models/preact_resnet.py``:

  * ``PreActResNetFeat``: a feat_dim projection and a linear classifier
    over it, returning (log-softmax class scores, unit features); the
    CIFAR-10 adversarial runs use it;
  * ``PreActResNetPlain``: a plain classifier returning (logits, pooled
    features).

NCHW input.  BatchNorm uses PyTorch's defaults (momentum 0.1, eps 1e-5),
which equal flax's momentum 0.9 and eps 1e-5.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ._init import init_weights
from .cnn import l2_normalize

__all__ = ["PreActBlock", "PreActBottleneck", "PreActResNetFeat",
           "PreActResNetPlain", "preact_resnet18", "preact_resnet34",
           "preact_resnet50", "preact_resnet101", "preact_resnet152"]


def _shortcut(in_planes: int, out_planes: int, stride: int) -> nn.Sequential:
    """A 1x1 conv on the pre-activated input where the shape changes, else
    nothing (the block adds its raw input)."""
    if stride == 1 and in_planes == out_planes:
        return nn.Sequential()
    return nn.Sequential(nn.Conv2d(in_planes, out_planes, 1, stride,
                                   bias=False))


def _add_shortcut(block, x, out):
    return block.shortcut(out) if len(block.shortcut) else x


class PreActBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(in_planes)
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.shortcut = _shortcut(in_planes, planes * self.expansion, stride)

    def forward(self, x):
        out = F.relu(self.bn1(x))
        shortcut = _add_shortcut(self, x, out)
        out = self.conv1(out)
        out = self.conv2(F.relu(self.bn2(out)))
        return out + shortcut


class PreActBottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(in_planes)
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1,
                               bias=False)
        self.shortcut = _shortcut(in_planes, planes * self.expansion, stride)

    def forward(self, x):
        out = F.relu(self.bn1(x))
        shortcut = _add_shortcut(self, x, out)
        out = self.conv1(out)
        out = self.conv2(F.relu(self.bn2(out)))
        out = self.conv3(F.relu(self.bn3(out)))
        return out + shortcut


class _PreActTrunk(nn.Module):
    """3x3 stem and four stages of pre-activation blocks."""

    def __init__(self, block: type, stage_sizes: Sequence[int],
                 in_channel: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channel, 64, 3, 1, 1, bias=False)
        in_planes = 64
        for stage, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), stage_sizes), start=1):
            layers = []
            for i in range(blocks):
                stride = 2 if (stage > 1 and i == 0) else 1
                layers.append(block(in_planes, planes, stride))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*layers))
        self.out_planes = in_planes

    def forward(self, x):
        out = self.conv1(x)
        return self.layer4(self.layer3(self.layer2(self.layer1(out))))


def _pool_flat(out: torch.Tensor) -> torch.Tensor:
    """The 4x4 average pool (stride 4) and a flatten in (row, column,
    channel) order, as the flax model flattens, in float32 or wider."""
    out = F.avg_pool2d(out, 4, stride=4)
    out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)
    return out.to(torch.promote_types(out.dtype, torch.float32))


class PreActResNetFeat(nn.Module):
    """Returns (log-softmax class scores, unit feat_dim features).
    ``generator``: draw the initial weights from it (``init_weights``)."""

    def __init__(self, block: type = PreActBlock,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 feat_dim: int = 128, num_classes: int = 10,
                 in_channel: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.trunk = _PreActTrunk(block, stage_sizes, in_channel)
        self.bn = nn.BatchNorm2d(self.trunk.out_planes)
        self.feat = nn.Linear(self.trunk.out_planes, feat_dim)
        self.linear = nn.Linear(feat_dim, num_classes)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x):
        out = _pool_flat(F.relu(self.bn(self.trunk(x))))
        feat = self.feat(out)
        pred = self.linear(feat)
        return torch.log_softmax(pred, dim=1), l2_normalize(feat)


class PreActResNetPlain(nn.Module):
    """Returns (logits, pooled features); no BatchNorm after the trunk."""

    def __init__(self, block: type = PreActBlock,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 10, in_channel: int = 3):
        super().__init__()
        self.trunk = _PreActTrunk(block, stage_sizes, in_channel)
        self.linear = nn.Linear(self.trunk.out_planes, num_classes)

    def forward(self, x):
        out = _pool_flat(self.trunk(x))
        return self.linear(out), out


def preact_resnet18(**kw) -> PreActResNetFeat:
    return PreActResNetFeat(PreActBlock, (2, 2, 2, 2), **kw)


def preact_resnet34(**kw) -> PreActResNetFeat:
    return PreActResNetFeat(PreActBlock, (3, 4, 6, 3), **kw)


def preact_resnet50(**kw) -> PreActResNetFeat:
    return PreActResNetFeat(PreActBottleneck, (3, 4, 6, 3), **kw)


def preact_resnet101(**kw) -> PreActResNetFeat:
    return PreActResNetFeat(PreActBottleneck, (3, 4, 23, 3), **kw)


def preact_resnet152(**kw) -> PreActResNetFeat:
    return PreActResNetFeat(PreActBottleneck, (3, 8, 36, 3), **kw)
