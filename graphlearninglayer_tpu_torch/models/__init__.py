from .buildnet import BuildNet, init_weights, model_dict
from .cnn import l2_normalize
from .resnet import (BasicBlock, Bottleneck, ResNet, resnet18, resnet34,
                     resnet50, resnet101)

__all__ = [
    "BuildNet", "init_weights", "model_dict", "l2_normalize",
    "BasicBlock", "Bottleneck", "ResNet", "resnet18", "resnet34", "resnet50",
    "resnet101",
]
