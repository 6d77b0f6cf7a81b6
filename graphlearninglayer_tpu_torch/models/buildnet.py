"""Backbone + projection head + aux classifier (the reference's ``buildnet``).

Twin of ``graphlearninglayer_tpu/models/buildnet.py``: an encoder from the
model registry, a 'linear' / 'mlp' / 'no' projection head to ``feat_dim``,
and an auxiliary MLP classifier (-> 32 -> num_classes, optional softmax).
The forward returns ``(pred, normalized_features)``: the GL head consumes
the unit-norm features, the MLP path consumes ``pred``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from . import resnet as _resnet
from . import wrn as _wrn
from ._init import init_weights
from .cnn import CifarCNN, l2_normalize

__all__ = ["BuildNet", "model_dict", "init_weights", "nhwc_input",
           "encoder_layouts"]

# name -> (encoder constructor (``in_channel`` keyword), feature dim)
model_dict: dict[str, tuple[Callable[..., nn.Module], int]] = {
    "resnet18": (_resnet.resnet18, 512),
    # space-to-depth stem, not reference-equivalent (models/resnet.py)
    "resnet18_s2d": (_resnet.resnet18_s2d, 512),
    "resnet34": (_resnet.resnet34, 512),
    "resnet50": (_resnet.resnet50, 2048),
    "resnet101": (_resnet.resnet101, 2048),
    "wrn-28-2": (_wrn.wrn_28_2, 128),
    "wrn-28-8": (_wrn.wrn_28_8, 512),
    "cifarcnn": (CifarCNN, 128),
}

# CUDA encoder inputs since the process started, by how they arrived:
# already NHWC-strided ("nhwc") or given NHWC strides by nhwc_input
# ("restrided")
encoder_layouts = {"nhwc": 0, "restrided": 0}


def nhwc_input(x: torch.Tensor, cuda: bool | None = None) -> torch.Tensor:
    """``x`` with NHWC strides when it is a 4-D CUDA tensor (``cuda``
    overrides ``x.is_cuda``); any other input unchanged.

    cuDNN's TF32 convolutions on Hopper are NHWC: an NCHW-strided input
    costs a transpose into and out of every convolution, and batch norm
    falls back to its per-channel NCHW kernels.  An input that is NHWC
    already (a permuted view of NHWC rows) comes back as it is.  With one
    channel a contiguous NCHW tensor passes ``is_contiguous(memory_format=
    torch.channels_last)``, yet PyTorch reads its strides as NCHW, so
    ``x.contiguous(memory_format=torch.channels_last)`` would return it
    unchanged; the same memory viewed as (N, H, W, 1) and permuted has the
    strides cuDNN takes for NHWC, at no copy (cuDNN still runs that
    one-channel stem by an NCHW engine and transposes its output alone).
    More channels take a channels_last copy.  Both are differentiable: the
    input gradient reaches ``x`` in ``x``'s own strides.
    """
    if not (x.is_cuda if cuda is None else cuda) or x.dim() != 4:
        return x
    if x.stride(1) == 1 and x.is_contiguous(
            memory_format=torch.channels_last):
        encoder_layouts["nhwc"] += 1
        return x
    encoder_layouts["restrided"] += 1
    n, c, h, w = x.shape
    if c == 1:
        return x.reshape(n, h, w, 1).permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last)


class BuildNet(nn.Module):
    """Encoder -> head -> aux classifier; returns (pred, unit features).

    ``forward`` takes NCHW-shaped float input (PyTorch's habit; the JAX
    BuildNet takes NHWC) in any strides.  On CUDA the encoder runs it
    channels_last whatever strides the caller passes (:func:`nhwc_input`:
    a one-channel batch takes a zero-copy view, as PyTorch reads a
    contiguous (N, 1, H, W) tensor as NCHW); on the CPU the input reaches
    the encoder as given.  ``dtype`` is the ENCODER compute dtype: bf16
    runs the encoder under ``torch.autocast``, while parameters stay
    float32.  The projection head, the aux classifier and the L2 normalize
    always run in float32 and the features leave as float32, because the
    graph op needs full-precision distances.

    ``in_channel``: the input images' channels (1 for the MNIST family and
    the grayscale synthetic set; the flax encoders infer it).

    ``generator``: draw the initial weights from this generator (PyTorch's
    default initialization schemes) instead of the global one.
    """

    def __init__(self, name: str = "resnet18", head: str = "mlp",
                 feat_dim: int = 128, num_classes: int = 10,
                 softmax: bool = True, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 in_channel: int = 3):
        super().__init__()
        model_fn, dim_in = model_dict[name]
        self.encoder = model_fn(in_channel=in_channel)
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
        x = nhwc_input(x)
        if self.dtype == torch.float32:   # no autocast: runs on any device
            feat = self.encoder(x)
        else:
            with torch.autocast(device_type=x.device.type, dtype=self.dtype):
                feat = self.encoder(x)
        feat = self.head(feat)
        pred = self.linear(feat)
        if self.softmax:
            pred = torch.softmax(pred, dim=1)
        return pred, l2_normalize(feat)
