"""Carry JAX (flax) model weights into the port.

``params_from_jax(params, batch_stats, model=None)`` takes a flax model's
trees (nested dicts of numpy-convertible arrays) and returns the
``state_dict`` of its twin in the port, ``model``; with ``model=None`` the
trees are a flax ``BuildNet``'s, whose twin is built from what they hold.
The port keeps its own copy of the name tables; the JAX package's
``utils/torch_import.py`` reads the BuildNet ones the other way.

A flax module names its layers by type and creation order (``Conv_0``,
``BatchNorm_1``, a block ``PreActBlock_3``); each torch class below lists,
per flax type, its own layers in that order (``_LAYERS``).  Blocks go in
stage order (``layer1.0``, ``layer1.1``, ``layer2.0``, ...).  A shortcut
conv that a block lacks drops out of its list.  Leaves:

  * conv kernels HWIO -> OIHW; dense kernels (in, out) -> (out, in), and
    a dense layer fed by a flatten gets its input rows reordered from
    flax's (row, column, channel) order to PyTorch's (channel, row,
    column);
  * BN ``scale / bias / mean / var`` -> ``weight / bias / running_mean /
    running_var``, plus ``num_batches_tracked`` = 0 (both frameworks use a
    fixed momentum, so the count is never read);
  * a ``WeightNorm``-wrapped conv (``_WNConv``): its kernel v ->
    ``parametrizations.weight.original1``, its per-output ``scale`` g ->
    ``parametrizations.weight.original0`` (shape (out, 1, 1, 1)).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

__all__ = ["params_from_jax"]

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}

# torch class -> {flax type: the class's layers in flax creation order}.
# A layer "fc1<conv3" is fed by a flatten of conv3's output channels.
_LAYERS = {
    "BasicBlock": {"Conv": ["conv1", "conv2", "shortcut.0"],
                   "BatchNorm": ["bn1", "bn2", "shortcut.1"]},
    "Bottleneck": {"Conv": ["conv1", "conv2", "conv3", "shortcut.0"],
                   "BatchNorm": ["bn1", "bn2", "bn3", "shortcut.1"]},
    "PreActBlock": {"Conv": ["shortcut.0", "conv1", "conv2"],
                    "BatchNorm": ["bn1", "bn2"]},
    "PreActBottleneck": {"Conv": ["shortcut.0", "conv1", "conv2", "conv3"],
                         "BatchNorm": ["bn1", "bn2", "bn3"]},
    "WideBasic": {"Conv": ["conv1", "conv2", "shortcut.0"],
                  "BatchNorm": ["bn1", "bn2"]},
    "ResNet": {"Conv": ["conv1"], "BatchNorm": ["bn1"]},
    "_PreActTrunk": {"Conv": ["conv1"]},
    "WideResNet": {"Conv": ["conv1"], "BatchNorm": ["bn"]},
    "PreActResNetFeat": {"_PreActTrunk": ["trunk"], "BatchNorm": ["bn"],
                         "Dense": ["feat", "linear"]},
    "PreActResNetPlain": {"_PreActTrunk": ["trunk"], "Dense": ["linear"]},
    "CifarCNN": {"_WNConv": [f"conv{s}{j}" for s in "123" for j in "abc"],
                 "BatchNorm": [f"bn{s}{j}" for s in "123" for j in "abc"]},
    "CustomCNN": {"Conv": ["conv1", "conv2", "conv3"],
                  "Dense": ["fc1<conv3", "fc2", "fc3"]},
    "_SmallCNNTrunk": {"Conv": ["conv1", "conv2", "conv3", "conv4"],
                       "Dense": ["fc1<conv4", "fc2"]},
    "SmallCNN": {"_SmallCNNTrunk": ["trunk"], "Dense": ["linear"]},
    "SmallCNNGL": {"_SmallCNNTrunk": ["trunk"]},
    "SupConResNet": {"ResNet": ["encoder"], "Dense": ["head.0", "head.2"]},
    "SupCEResNet": {"ResNet": ["encoder"], "Dense": ["fc"]},
    "LinearClassifier": {"Dense": ["fc"]},
    "SmallNet": {"Conv": ["conv1", "conv2"],
                 "Dense": ["fc1<conv2", "fc2"]},
}
# flax layer types that hold leaves, and how to read them (BuildNet's
# named heads are dense layers)
_LEAF_TYPES = {"Conv": "Conv", "BatchNorm": "BatchNorm", "Dense": "Dense",
               "_WNConv": "_WNConv", "head": "Dense", "linear": "Dense"}
_BLOCKS = ("BasicBlock", "Bottleneck", "PreActBlock", "PreActBottleneck",
           "WideBasic")


def _layers(tmod: nn.Module) -> dict[str, list[str]]:
    """{flax type: the torch layers it maps to, in flax order} for one
    module."""
    cls = type(tmod).__name__
    if cls == "BuildNet":
        head = tmod.head
        heads = (["head.0", "head.2"] if isinstance(head, nn.Sequential)
                 else ["head"] if isinstance(head, nn.Linear) else [])
        return {"encoder": ["encoder"], "head": heads,
                "linear": ["linear.0", "linear.2"]}
    table = dict(_LAYERS[cls])
    if cls == "SupConResNet" and isinstance(tmod.head, nn.Linear):
        table["Dense"] = ["head"]
    blocks = [f"{name}.{i}" for name, seq in tmod.named_children()
              if name.startswith("layer") for i in range(len(seq))]
    if blocks:
        table.update({b: blocks for b in _BLOCKS})
    # a shortcut conv (and its BN) that this block does not have
    own = tmod.state_dict(keep_vars=True)
    return {t: [n for n in names
                if any(k.startswith(n.split("<")[0] + ".") for k in own)]
            for t, names in table.items()}


def _flatten_rows(kernel: np.ndarray, channels: int) -> np.ndarray:
    """Reorder a dense kernel's input rows from flax's NHWC flatten
    ((row, column) major, channel minor) to PyTorch's NCHW flatten."""
    rows, out = kernel.shape
    hw = rows // channels
    return kernel.reshape(hw, channels, out).transpose(1, 0, 2).reshape(
        rows, out)


def _leaves(ftype: str, tree: dict, tmod: nn.Module, name: str) -> dict:
    """The state_dict entries (keys relative to ``tmod``) of one flax layer
    ``tree`` of type ``ftype``, mapped onto ``tmod``'s layer ``name``."""
    name, _, feeder = name.partition("<")
    if ftype == "_WNConv":          # {Conv_0: {kernel, bias}, WeightNorm_0}
        conv, (g,) = tree["Conv_0"], tree["WeightNorm_0"].values()
        return {f"{name}.parametrizations.weight.original0":
                np.asarray(g).reshape(-1, 1, 1, 1),
                f"{name}.parametrizations.weight.original1":
                np.asarray(conv["kernel"]).transpose(3, 2, 0, 1),
                f"{name}.bias": np.asarray(conv["bias"])}
    out = {}
    for leaf, v in tree.items():
        v = np.asarray(v)
        if ftype == "BatchNorm":
            out[f"{name}.{_BN_LEAF[leaf]}"] = v
            if leaf == "mean":
                out[f"{name}.num_batches_tracked"] = np.int64(0)
        elif leaf == "bias":
            out[f"{name}.bias"] = v
        elif v.ndim == 4:                              # conv: HWIO -> OIHW
            out[f"{name}.weight"] = v.transpose(3, 2, 0, 1)
        else:                                          # dense: (in, out)
            if feeder:
                v = _flatten_rows(v, tmod.get_submodule(feeder).out_channels)
            out[f"{name}.weight"] = v.T
    return out


def _walk(tree: dict, tmod: nn.Module, prefix: str, sd: dict) -> None:
    """Map one flax scope ``tree`` onto ``tmod`` (state_dict prefix
    ``prefix``), recursing into sub-modules."""
    table = _layers(tmod)
    groups: dict[str, list[tuple[int, str]]] = {}
    for key in tree:
        ftype, _, idx = key.rpartition("_")
        if type(tmod).__name__ == "BuildNet" and ftype not in table:
            ftype = "encoder"                  # ResNet_0, WideResNet_0, ...
        groups.setdefault(ftype, []).append((int(idx), key))
    for ftype, members in groups.items():
        names = table.get(ftype)
        if names is None or len(names) != len(members):
            raise KeyError(f"{prefix or type(tmod).__name__}: flax layers "
                           f"{sorted(k for _, k in members)} have no place "
                           f"in {type(tmod).__name__} ({names})")
        for (_, key), name in zip(sorted(members), names):
            if ftype in _LEAF_TYPES:
                part = _leaves(_LEAF_TYPES[ftype], tree[key], tmod, name)
                sd.update({prefix + k: v for k, v in part.items()})
            else:
                _walk(tree[key], tmod.get_submodule(name), f"{prefix}{name}.",
                      sd)


def _buildnet_from_trees(params: dict) -> nn.Module:
    """The port's ``BuildNet`` (on the meta device) that a flax BuildNet's
    params tree describes."""
    from ..models import BuildNet

    enc_key = next(k for k in params if not k.startswith(("head_",
                                                           "linear_")))
    enc = params[enc_key]
    if enc_key.startswith("ResNet"):
        block = "Bottleneck" if any(k.startswith("Bottleneck")
                                    for k in enc) else "BasicBlock"
        nblocks = sum(k.startswith(block) for k in enc)
        stem = np.shape(enc["Conv_0"]["kernel"])
        s2d = stem[-1] == 128
        name = ("resnet18_s2d" if s2d else
                {("BasicBlock", 8): "resnet18", ("BasicBlock", 16): "resnet34",
                 ("Bottleneck", 16): "resnet50",
                 ("Bottleneck", 33): "resnet101"}[(block, nblocks)])
        in_channel = stem[2] // 4 if s2d else stem[2]
    elif enc_key.startswith("WideResNet"):
        width = np.shape(enc["BatchNorm_0"]["scale"])[0]
        name, in_channel = ("wrn-28-2" if width == 128 else "wrn-28-8",
                            np.shape(enc["Conv_0"]["kernel"])[2])
    else:
        name = "cifarcnn"
        in_channel = np.shape(enc["_WNConv_0"]["Conv_0"]["kernel"])[2]
    head = ("mlp" if "head_1" in params else
            "linear" if "head_0" in params else "no")
    last_head = params.get("head_1", params.get("head_0"))
    num_classes = np.shape(params["linear_1"]["kernel"])[1]
    kw = dict(name=name, head=head, num_classes=num_classes,
              in_channel=in_channel)
    if last_head is not None:
        kw["feat_dim"] = np.shape(last_head["kernel"])[1]
    with torch.device("meta"):
        return BuildNet(**kw)


def params_from_jax(params: dict, batch_stats: dict | None,
                    model: nn.Module | None = None) -> dict:
    """The port's state_dict for ``model`` from flax ``(params,
    batch_stats)``; ``model=None`` takes a ``BuildNet``, configured from
    the trees.  Raises ``KeyError`` on a flax layer it cannot place."""
    if model is None:
        model = _buildnet_from_trees(params)
    sd: dict = {}
    _walk(params, model, "", sd)
    _walk(batch_stats or {}, model, "", sd)
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}
