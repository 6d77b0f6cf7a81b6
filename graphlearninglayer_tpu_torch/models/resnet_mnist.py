"""1-channel (MNIST-style) ResNets and the SupCon-era wrappers (torch.nn).

Twin of ``graphlearninglayer_tpu/models/resnet_mnist.py``: the CIFAR-style
ResNet trunk with ``in_channel=1``, plus ``SupConResNet`` (encoder and a
normalized projection head), ``SupCEResNet`` (encoder and a linear
classifier), ``LinearClassifier`` (a probe head) and the small LeNet-style
``SmallNet``.  NCHW input.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cnn import Dropout, l2_normalize
from .resnet import BasicBlock, Bottleneck, ResNet

__all__ = ["mnist_resnet18", "mnist_resnet34", "mnist_resnet50",
           "mnist_resnet101", "mnist_model_dict", "SupConResNet",
           "SupCEResNet", "LinearClassifier", "SmallNet"]


def mnist_resnet18(in_channel: int = 1) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), in_channel=in_channel)


def mnist_resnet34(in_channel: int = 1) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), in_channel=in_channel)


def mnist_resnet50(in_channel: int = 1) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), in_channel=in_channel)


def mnist_resnet101(in_channel: int = 1) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), in_channel=in_channel)


# name -> (constructor, feature dim)
mnist_model_dict = {
    "resnet18": (mnist_resnet18, 512),
    "resnet34": (mnist_resnet34, 512),
    "resnet50": (mnist_resnet50, 2048),
    "resnet101": (mnist_resnet101, 2048),
}


class SupConResNet(nn.Module):
    """Encoder and a 'linear' / 'mlp' projection head, L2-normalized
    output."""

    def __init__(self, name: str = "resnet50", head: str = "mlp",
                 feat_dim: int = 128, in_channel: int = 1):
        super().__init__()
        model_fn, dim_in = mnist_model_dict[name]
        self.encoder = model_fn(in_channel=in_channel)
        if head == "linear":
            self.head = nn.Linear(dim_in, feat_dim)
        elif head == "mlp":
            self.head = nn.Sequential(nn.Linear(dim_in, dim_in), nn.ReLU(),
                                      nn.Linear(dim_in, feat_dim))
        else:
            raise NotImplementedError(f"head not supported: {head}")

    def forward(self, x):
        return l2_normalize(self.head(self.encoder(x)))


class SupCEResNet(nn.Module):
    """Encoder and a linear classifier."""

    def __init__(self, name: str = "resnet50", num_classes: int = 10,
                 in_channel: int = 1):
        super().__init__()
        model_fn, dim_in = mnist_model_dict[name]
        self.encoder = model_fn(in_channel=in_channel)
        self.fc = nn.Linear(dim_in, num_classes)

    def forward(self, x):
        return self.fc(self.encoder(x))


class LinearClassifier(nn.Module):
    """Linear probe over frozen features."""

    def __init__(self, name: str = "resnet50", num_classes: int = 10):
        super().__init__()
        _, feat_dim = mnist_model_dict[name]
        self.fc = nn.Linear(feat_dim, num_classes)

    def forward(self, features):
        return self.fc(features)


class SmallNet(nn.Module):
    """LeNet-style conv net (the reference's legacy ``Net``); returns
    log-softmax class scores of 28x28 inputs."""

    def __init__(self, num_classes: int = 10, in_channel: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channel, 32, 3)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.dropout1 = Dropout(0.25)
        self.dropout2 = Dropout(0.5)
        self.fc1 = nn.Linear(12 * 12 * 64, 128)
        self.fc2 = nn.Linear(128, num_classes)

    def forward(self, x):
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        x = self.dropout1(F.max_pool2d(x, 2))
        x = self.dropout2(F.relu(self.fc1(torch.flatten(x, 1))))
        return torch.log_softmax(self.fc2(x), dim=1)
