"""CIFAR-style ResNet encoders (torch.nn).

Twin of ``graphlearninglayer_tpu/models/resnet.py``: 3x3 stem (no maxpool),
four stages, global average pool, returning pooled feature vectors (512-d
for BasicBlock nets, 2048-d for Bottleneck nets).  NCHW input, PyTorch's
habit.  BatchNorm uses PyTorch's defaults, momentum 0.1 and eps 1e-5, which
equal flax's momentum 0.9 and eps 1e-5.

Module names follow the reference's state_dict (``conv1``, ``bn1``,
``layerL.B.convJ/bnJ``, ``shortcut.0/1``), so a reference checkpoint loads
as is and ``graphlearninglayer_tpu/utils/torch_import.py`` reads the port's
weights.

Under ``torch.autocast`` the convolutions run in the autocast dtype; the
pooled features are float32 (float64 for a float64 model).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "resnet18", "resnet18_s2d",
           "resnet34", "resnet50", "resnet101"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes * self.expansion:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes * self.expansion, 1, stride,
                          bias=False),
                nn.BatchNorm2d(planes * self.expansion))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.shortcut(x))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1,
                               bias=False)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes * self.expansion:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes * self.expansion, 1, stride,
                          bias=False),
                nn.BatchNorm2d(planes * self.expansion))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + self.shortcut(x))


class ResNet(nn.Module):
    """Returns pooled float32 features of dim 512 * expansion; input NCHW.

    ``s2d_stem=True`` (not reference-equivalent): the JAX package's
    space-to-depth stem.  2x2 pixel patches fold into channels (C x H x W
    -> 4C x H/2 x W/2, channel (dy * 2 + dx) * C + c, as the flax reshape
    orders them) before a 128-channel stem, stage 1 runs 128 channels, and
    only stages 3 and 4 stride.
    """

    def __init__(self, block: type, num_blocks: Sequence[int],
                 in_channel: int = 3, s2d_stem: bool = False):
        super().__init__()
        self.s2d_stem = s2d_stem
        stem = 128 if s2d_stem else 64
        self.conv1 = nn.Conv2d(4 * in_channel if s2d_stem else in_channel,
                               stem, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(stem)
        in_planes = stem
        first_stride = 3 if s2d_stem else 2
        for stage, (planes, blocks) in enumerate(
                zip((stem, 128, 256, 512), num_blocks), start=1):
            layers = []
            for i in range(blocks):
                stride = 2 if (stage >= first_stride and i == 0) else 1
                layers.append(block(in_planes, planes, stride))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*layers))

    def forward(self, x):
        if self.s2d_stem:
            b, c, h, w = x.shape
            x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(
                0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        # pool in (at least) float32 whatever the compute dtype: the graph
        # head consumes these features directly
        out = out.to(torch.promote_types(out.dtype, torch.float32))
        return torch.mean(out, dim=(2, 3))


def resnet18(**kw) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), **kw)


def resnet18_s2d(**kw) -> ResNet:
    """The space-to-depth-stem ResNet-18 (see ``ResNet``)."""
    return ResNet(BasicBlock, (2, 2, 2, 2), s2d_stem=True, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), **kw)
