"""ResNet-18 with a projection head, in plain PyTorch functions.

The CIFAR-style ResNet-18 of He et al. (arXiv:1512.03385) as the
SupContrast code that the GraphLearningLayer reference trains: a 3x3 stem
of 64 channels with no max-pool, four stages of two basic blocks (64, 128,
256, 512 channels; stages 2-4 stride 2 in their first block, with a 1x1
convolution and batch norm on the shortcut), global average pooling, then
a 'linear' (512 -> feat_dim) or 'mlp' (512 -> 512 -> ReLU -> feat_dim)
head and the unit-norm features.  Batch norm has eps 1e-5.

Parameters come in a dict keyed as the measured program's state dict names
them (``encoder.layer2.0.conv1.weight``, ``head.0.bias``, ...), so the
benchmark hands both sides the same tensors.  Nothing here runs a kernel of
the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


def _bn(h, p, name, train):
    """Batch norm of ``h`` by layer ``name``: by the batch's statistics in
    train mode, by the running ones in ``p`` in eval mode."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if train:
        return F.batch_norm(h, None, None, w, b, True, 0.0, BN_EPS)
    return F.batch_norm(h, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], w, b, False, 0.0, BN_EPS)


def encoder(p: dict, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Pooled (B, 512) features of NCHW images ``x``."""
    out = F.relu(_bn(F.conv2d(x, p["encoder.conv1.weight"], padding=1), p,
                     "encoder.bn1", train))
    for s, (planes, stride0) in enumerate(STAGES, start=1):
        for blk in range(2):
            pre = f"encoder.layer{s}.{blk}"
            stride = stride0 if blk == 0 else 1
            h = F.relu(_bn(F.conv2d(out, p[f"{pre}.conv1.weight"],
                                    stride=stride, padding=1), p,
                           f"{pre}.bn1", train))
            h = _bn(F.conv2d(h, p[f"{pre}.conv2.weight"], padding=1), p,
                    f"{pre}.bn2", train)
            if f"{pre}.shortcut.0.weight" in p:
                sc = _bn(F.conv2d(out, p[f"{pre}.shortcut.0.weight"],
                                  stride=stride), p, f"{pre}.shortcut.1",
                         train)
            else:
                sc = out
            out = F.relu(h + sc)
    return out.float().mean(dim=(2, 3))


def features(p: dict, x: torch.Tensor, head: str,
             train: bool) -> torch.Tensor:
    """Unit-norm (B, feat_dim) features: encoder, projection head, then
    x / max(|x|, 1e-12)."""
    f = encoder(p, x, train)
    if head == "linear":
        f = F.linear(f, p["head.weight"], p["head.bias"])
    elif head == "mlp":
        f = F.linear(F.relu(F.linear(f, p["head.0.weight"],
                                     p["head.0.bias"])),
                     p["head.2.weight"], p["head.2.bias"])
    else:
        raise ValueError(f"unknown head {head!r}")
    return f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)
                          .clamp_min(1e-24))
