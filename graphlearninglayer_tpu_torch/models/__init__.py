from .buildnet import BuildNet, init_weights, model_dict
from .cnn import (CifarCNN, CustomCNN, Dropout, SmallCNN, SmallCNNGL,
                  l2_normalize)
from .preact_resnet import (PreActBlock, PreActBottleneck, PreActResNetFeat,
                            PreActResNetPlain, preact_resnet18,
                            preact_resnet34, preact_resnet50,
                            preact_resnet101, preact_resnet152)
from .resnet import (BasicBlock, Bottleneck, ResNet, resnet18, resnet18_s2d,
                     resnet34, resnet50, resnet101)
from .resnet_mnist import (LinearClassifier, SmallNet, SupCEResNet,
                           SupConResNet, mnist_model_dict, mnist_resnet18,
                           mnist_resnet34, mnist_resnet50, mnist_resnet101)
from .wrn import WideBasic, WideResNet, wrn_28_2, wrn_28_8

__all__ = [
    "BuildNet", "init_weights", "model_dict",
    "CifarCNN", "CustomCNN", "Dropout", "SmallCNN", "SmallCNNGL",
    "l2_normalize",
    "PreActBlock", "PreActBottleneck", "PreActResNetFeat",
    "PreActResNetPlain", "preact_resnet18", "preact_resnet34",
    "preact_resnet50", "preact_resnet101", "preact_resnet152",
    "BasicBlock", "Bottleneck", "ResNet", "resnet18", "resnet18_s2d",
    "resnet34", "resnet50", "resnet101",
    "LinearClassifier", "SmallNet", "SupCEResNet", "SupConResNet",
    "mnist_model_dict", "mnist_resnet18", "mnist_resnet34", "mnist_resnet50",
    "mnist_resnet101",
    "WideBasic", "WideResNet", "wrn_28_2", "wrn_28_8",
]
