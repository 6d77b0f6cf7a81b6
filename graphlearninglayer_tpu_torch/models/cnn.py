"""Small CNN encoders and classifiers (torch.nn).

Twin of ``graphlearninglayer_tpu/models/cnn.py``:

  * ``CustomCNN``: the 3-conv MNIST net returning (softmax probabilities,
    unit 128-d features), the feature tap at fc1;
  * ``CifarCNN``: the Mean-Teacher 13-layer weight-normed CNN returning unit
    128-d features;
  * the Small-CNN pair of the adversarial drivers: ``SmallCNN``
    (log-softmax classifier, zero-initialized final linear) and
    ``SmallCNNGL`` (the same trunk with unit 200-d features, no final
    linear).

NCHW input.  A flatten ahead of a linear layer is PyTorch's (channel,
row, column) order; the flax models flatten NHWC, and
``utils/jax_params.py`` permutes those linear layers' input rows.
Dropout draws its masks from the module's ``generator`` (see
:class:`Dropout`).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils.parametrizations import weight_norm

from ._init import init_weights

__all__ = ["l2_normalize", "Dropout", "CustomCNN", "CifarCNN", "SmallCNN",
           "SmallCNNGL"]


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics: x / max(||x||, eps).

    Written via max *inside* the sqrt so the gradient at x = 0 is finite
    (the identity over eps) instead of NaN.
    """
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(sq.clamp_min(eps * eps))


class Dropout(nn.Module):
    """flax ``nn.Dropout`` semantics: in training, keep each entry with
    probability 1 - p and scale the kept ones by 1 / (1 - p).  The mask is
    drawn from ``self.generator`` (a ``torch.Generator`` on the input's
    device, set by the caller), or from PyTorch's global generator when it
    is None.  A fresh mask every call."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device,
                          dtype=x.dtype) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class CustomCNN(nn.Module):
    """28x28 input -> (softmax over classes, unit 128-d features)."""

    def __init__(self, num_classes: int = 10, in_channel: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channel, 64, 3, padding=1)
        self.conv2 = nn.Conv2d(64, 128, 3, padding=1)
        self.conv3 = nn.Conv2d(128, 256, 3, padding=1)
        self.fc1 = nn.Linear(7 * 7 * 256, 128)
        self.fc2 = nn.Linear(128, 1024)
        self.fc3 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = F.max_pool2d(F.relu(self.conv3(x)), 2)
        feat = F.leaky_relu(self.fc1(torch.flatten(x, 1)), 0.01)
        x = F.leaky_relu(self.fc2(feat), 0.01)
        x = F.leaky_relu(self.fc3(x), 0.01)
        return torch.softmax(x, dim=1), l2_normalize(feat)


def _wn_conv(cin: int, cout: int, kernel: int, padding: int = 0) -> nn.Conv2d:
    """Conv with weight normalization, w = g v / ||v||, the norm over every
    axis but the output channels (``dim=0``), as flax's ``nn.WeightNorm``
    over a conv kernel.  flax forms v * rsqrt(||v||^2 + 1e-12): its epsilon
    moves w by a factor of 1 - 5e-13 / ||v||^2, which is below 1e-9
    relative for any ||v||^2 above 5e-4, and it keeps w finite where v = 0,
    where PyTorch's w is NaN."""
    return weight_norm(nn.Conv2d(cin, cout, kernel, padding=padding), dim=0)


class CifarCNN(nn.Module):
    """Mean-Teacher 13-layer CNN; returns unit 128-d features (float32 or
    wider under autocast)."""

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5,
                 in_channel: int = 3):
        super().__init__()
        # the reference's layer names: block 1 (a, b, c), 2 and 3
        plan = {"1a": (in_channel, 128, 3, 1), "1b": (128, 128, 3, 1),
                "1c": (128, 128, 3, 1), "2a": (128, 256, 3, 1),
                "2b": (256, 256, 3, 1), "2c": (256, 256, 3, 1),
                "3a": (256, 512, 3, 0), "3b": (512, 256, 1, 0),
                "3c": (256, 128, 1, 0)}
        for name, p in plan.items():
            setattr(self, f"conv{name}", _wn_conv(*p))
            setattr(self, f"bn{name}", nn.BatchNorm2d(p[1]))
        self.drop1 = Dropout(dropout_rate)
        self.drop2 = Dropout(dropout_rate)

    def _block(self, x, stage: int):
        for j in "abc":
            conv = getattr(self, f"conv{stage}{j}")
            bn = getattr(self, f"bn{stage}{j}")
            x = F.leaky_relu(bn(conv(x)), 0.1)
        return x

    def forward(self, x):
        x = self.drop1(F.max_pool2d(self._block(x, 1), 2))
        x = self.drop2(F.max_pool2d(self._block(x, 2), 2))
        x = self._block(x, 3)
        # the reference pools a fixed 6x6 window, right for 32x32 inputs
        # only (6x6 before the pool); the window is clamped to the spatial
        # extent, so 28x28 inputs (5x5) work and 32x32 is unchanged
        x = F.avg_pool2d(x, (min(6, x.shape[2]), min(6, x.shape[3])),
                         stride=2)
        x = x.reshape(x.shape[0], 128)
        return l2_normalize(x.to(torch.promote_types(x.dtype, torch.float32)))


class _SmallCNNTrunk(nn.Module):
    """The Small-CNN's conv trunk and fc stack (valid padding, 28x28 ->
    4x4x64 -> fc 200 -> fc 200)."""

    def __init__(self, dropout_rate: float = 0.5, in_channel: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channel, 32, 3)
        self.conv2 = nn.Conv2d(32, 32, 3)
        self.conv3 = nn.Conv2d(32, 64, 3)
        self.conv4 = nn.Conv2d(64, 64, 3)
        self.fc1 = nn.Linear(4 * 4 * 64, 200)
        self.dropout = Dropout(dropout_rate)
        self.fc2 = nn.Linear(200, 200)

    def forward(self, x):
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        x = F.max_pool2d(x, 2)
        x = F.relu(self.conv4(F.relu(self.conv3(x))))
        x = F.max_pool2d(x, 2)
        x = self.dropout(F.relu(self.fc1(torch.flatten(x, 1))))
        return self.fc2(x)


class SmallCNN(nn.Module):
    """MLP-head variant: returns log-softmax class scores.

    The final linear is zero-initialized (weights and bias), as the
    reference's ``nn.init.constant_(self.linear.{weight,bias}, 0)``: at
    epoch 0 the model outputs the uniform distribution.  ``generator``:
    draw the other layers' initial weights from it (``init_weights``)."""

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5,
                 in_channel: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.trunk = _SmallCNNTrunk(dropout_rate, in_channel)
        self.linear = nn.Linear(200, num_classes)
        if generator is not None:
            init_weights(self, generator)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x):
        x = self.linear(F.relu(self.trunk(x)))
        return torch.log_softmax(x, dim=1)


class SmallCNNGL(nn.Module):
    """GL-head variant: returns unit 200-d features (no final linear or
    relu)."""

    def __init__(self, dropout_rate: float = 0.5, in_channel: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.trunk = _SmallCNNTrunk(dropout_rate, in_channel)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x):
        return l2_normalize(self.trunk(x))
