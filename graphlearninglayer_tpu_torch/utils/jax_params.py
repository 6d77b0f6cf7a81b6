"""Carry JAX BuildNet weights into the port.

``params_from_jax(params, batch_stats)`` takes the JAX package's flax
``BuildNet`` trees (nested dicts of numpy-convertible arrays) and returns the
port's ``BuildNet`` ``state_dict``.  It is the inverse of the JAX package's
``utils/torch_import.py`` translation; the port keeps its own copy of the
name table:

  * ``<Encoder>_0/Conv_0 / BatchNorm_0``          -> ``encoder.conv1 / bn1``
  * ``<Encoder>_0/<Block>_{i}/Conv_{J-1} / BatchNorm_{J-1}``
        -> ``encoder.layerL.B.convJ / bnJ``, where blocks are numbered
           sequentially across stages and a stage starts at block 0 and at
           every later block with a shortcut;
  * the block's last ``Conv_n / BatchNorm_n`` (n = convs in the main branch:
    2 for BasicBlock, 3 for Bottleneck) -> ``shortcut.0 / shortcut.1``;
  * ``head_0 / head_1`` -> ``head.0 / head.2`` (mlp) or ``head`` (linear);
  * ``linear_0 / linear_1`` -> ``linear.0 / linear.2``;
  * conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in);
  * BN ``scale / bias / mean / var`` -> ``weight / bias / running_mean /
    running_var``, plus ``num_batches_tracked`` = 0 (both frameworks use a
    fixed momentum, so the count is never read).
"""
from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["params_from_jax"]

_BN_LEAF = {("params", "scale"): "weight", ("params", "bias"): "bias",
            ("batch_stats", "mean"): "running_mean",
            ("batch_stats", "var"): "running_var"}
_DENSE_LEAF = {"kernel": "weight", "bias": "bias"}
_HEADS = ("head_0", "head_1", "linear_0", "linear_1")


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _block_places(enc_tree: dict, block_name: str, nconv: int):
    """{flax block name: (stage, index within stage)}."""
    ids = sorted(int(m.group(1)) for k in enc_tree
                 if (m := re.fullmatch(rf"{block_name}_(\d+)", k)))
    places, stage, b = {}, 0, 0
    for i in ids:
        name = f"{block_name}_{i}"
        if i == ids[0] or f"Conv_{nconv}" in enc_tree[name]:
            stage, b = stage + 1, 0
        else:
            b += 1
        places[name] = (stage, b)
    return places


def params_from_jax(params: dict, batch_stats: dict) -> dict:
    """The port's ``BuildNet`` state_dict from JAX ``(params,
    batch_stats)``; raises ``KeyError`` on a leaf it cannot place."""
    enc = next(k for k in params if k not in _HEADS)
    block_name = "Bottleneck" if any(k.startswith("Bottleneck")
                                     for k in params[enc]) else "BasicBlock"
    nconv = 3 if block_name == "Bottleneck" else 2
    places = _block_places(params[enc], block_name, nconv)
    mlp_head = "head_1" in params

    def bn_or_conv(prefix, layer, leaf_key, col):
        m = re.fullmatch(r"(Conv|BatchNorm)_(\d+)", layer)
        kind, j = m.group(1), int(m.group(2))
        if prefix == "encoder" and j == 0:
            name = "encoder." + ("conv1" if kind == "Conv" else "bn1")
        elif prefix == "encoder":
            raise KeyError(layer)
        elif j == nconv:
            name = f"{prefix}.shortcut." + ("0" if kind == "Conv" else "1")
        else:
            name = f"{prefix}." + ("conv" if kind == "Conv" else "bn") \
                + str(j + 1)
        if kind == "Conv":
            return f"{name}.weight", (3, 2, 0, 1)         # HWIO -> OIHW
        return f"{name}.{_BN_LEAF[(col, leaf_key)]}", None

    sd = {}
    trees = (("params", params), ("batch_stats", batch_stats or {}))
    for col, tree in trees:
        for path, v in _flatten(tree).items():
            v = np.asarray(v)
            perm = None
            if path[0] == enc:
                if len(path) == 3:
                    key, perm = bn_or_conv("encoder", path[1], path[2], col)
                else:
                    s, b = places[path[1]]
                    key, perm = bn_or_conv(f"encoder.layer{s}.{b}", path[2],
                                           path[3], col)
            else:
                top, leaf = path
                group, idx = top.rsplit("_", 1)
                if group == "head" and not mlp_head:
                    key = f"head.{_DENSE_LEAF[leaf]}"
                else:
                    key = f"{group}.{2 * int(idx)}.{_DENSE_LEAF[leaf]}"
                if leaf == "kernel":
                    perm = (1, 0)                 # (in,out) -> (out,in)
            if perm is not None:
                v = np.transpose(v, perm)
            sd[key] = torch.tensor(np.ascontiguousarray(v))
            if key.endswith(".running_mean"):
                sd[key.replace("running_mean", "num_batches_tracked")] = \
                    torch.tensor(0, dtype=torch.long)
    return sd
