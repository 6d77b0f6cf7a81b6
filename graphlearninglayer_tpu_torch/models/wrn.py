"""WideResNet feature extractors (torch.nn).

Twin of ``graphlearninglayer_tpu/models/wrn.py`` (the reference WRN-28-2 /
WRN-28-8): pre-activation wide basic blocks with biased convs and no final
linear, returning pooled features (128-d for width 2, 512-d for width 8).
NCHW input.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cnn import Dropout

__all__ = ["WideBasic", "WideResNet", "wrn_28_2", "wrn_28_8"]


class WideBasic(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(in_planes)
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1)
        self.dropout = Dropout(dropout_rate)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride))

    def forward(self, x):
        out = self.dropout(self.conv1(F.relu(self.bn1(x))))
        out = self.conv2(F.relu(self.bn2(out)))
        return out + self.shortcut(x)


class WideResNet(nn.Module):
    def __init__(self, depth: int = 28, widen_factor: int = 2,
                 dropout_rate: float = 0.0, in_channel: int = 3):
        super().__init__()
        if (depth - 4) % 6 != 0:
            raise ValueError("depth must be 6n+4")
        n = (depth - 4) // 6
        self.conv1 = nn.Conv2d(in_channel, 16, 3, padding=1)
        in_planes = 16
        for stage, planes in enumerate((16 * widen_factor, 32 * widen_factor,
                                        64 * widen_factor), start=1):
            layers = []
            for i in range(n):
                stride = 2 if (stage > 1 and i == 0) else 1
                layers.append(WideBasic(in_planes, planes, stride,
                                        dropout_rate))
                in_planes = planes
            setattr(self, f"layer{stage}", nn.Sequential(*layers))
        self.bn = nn.BatchNorm2d(in_planes)

    def forward(self, x):
        out = self.layer3(self.layer2(self.layer1(self.conv1(x))))
        out = F.relu(self.bn(out))
        # pool in float32 or wider whatever the compute dtype.  The
        # reference pools a fixed 8x8 window, right for 32x32 inputs only;
        # the window is clamped to the spatial extent (28x28 inputs are 7x7
        # here), and larger inputs flatten several windows, as the
        # reference does
        out = out.to(torch.promote_types(out.dtype, torch.float32))
        win = (min(8, out.shape[2]), min(8, out.shape[3]))
        out = F.avg_pool2d(out, win, stride=win)
        # (row, column, channel) order, as the flax model flattens, so the
        # features agree with it when several windows remain
        return out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)


def wrn_28_2(**kw) -> WideResNet:
    return WideResNet(28, 2, 0.0, **kw)


def wrn_28_8(**kw) -> WideResNet:
    return WideResNet(28, 8, 0.0, **kw)
