"""The encoder that configurations name ``"model": "resnet18"``: the
CIFAR-style ResNet-18 (3x3 stem, no max-pool) with its projection head.

Everything of the benchmark that depends on the encoder sits here, found by
the configuration's ``model``: the program's model (the port's BuildNet),
the plain reference's features (``reference/resnet.py``) and the work of
one image's forward pass, layer by layer (``common/counts.py`` turns it
into the FLOPs of a step).  Another encoder is another file beside this
one.
"""
from __future__ import annotations

from ..reference import resnet

# (planes, blocks, first stride) of the four stages
_STAGES = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))


def program_model(cfg: dict):
    """The port's model of the configuration; its weights are replaced by
    the benchmark's from the seed."""
    from graphlearninglayer_tpu_torch.models import BuildNet

    return BuildNet(cfg["model"], head=cfg["head"], feat_dim=cfg["feat_dim"],
                    num_classes=cfg["num_classes"], softmax=True,
                    in_channel=cfg["image_shape"][2])


def features(p: dict, x, cfg: dict, train: bool):
    """The plain reference's unit-norm features of NCHW images ``x`` from
    the parameters and buffers ``p`` (named as the program's state dict)."""
    return resnet.features(p, x, cfg["head"], train)


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def layers(cfg: dict) -> list[tuple[str, int]]:
    """(name, MACs an image) of every convolution and linear layer, the
    stem first, in forward order: the encoder, the projection head
    ('linear' or 'mlp') and the auxiliary classifier (feat_dim -> 32 ->
    num_classes)."""
    h, w, channels = cfg["image_shape"]
    feat_dim, head = cfg["feat_dim"], cfg["head"]
    out = [("stem", 9 * channels * 64 * h * w)]
    c_in = 64
    for stage, (planes, blocks, stride0) in enumerate(_STAGES, start=1):
        for b in range(blocks):
            stride = stride0 if b == 0 else 1
            ho, wo = _conv_out(h, 3, stride, 1), _conv_out(w, 3, stride, 1)
            name = f"layer{stage}.{b}"
            out.append((f"{name}.conv1", 9 * c_in * planes * ho * wo))
            out.append((f"{name}.conv2", 9 * planes * planes * ho * wo))
            if stride != 1 or c_in != planes:
                out.append((f"{name}.shortcut", c_in * planes * ho * wo))
            c_in, h, w = planes, ho, wo
    if head == "mlp":
        out += [("head.0", 512 * 512), ("head.2", 512 * feat_dim)]
    elif head == "linear":
        out.append(("head", 512 * feat_dim))
    else:
        raise ValueError(f"unknown head {head!r}")
    out += [("aux.0", feat_dim * 32), ("aux.2", 32 * cfg["num_classes"])]
    return out
