"""The GL training step and PGD's inner loop, in plain PyTorch.

One step: unit-norm features of the base + batch stack in train mode
(batch statistics), each row's k nearest rows, the graph layer over them
with the base labels, the custom cross-entropy on the batch labels, then
one optimizer update:

* SGD with momentum m and coupled weight decay wd: d = g + wd p,
  buf = d (first step) or m buf + d, p -= lr buf;
* Adam (beta 0.9, 0.999, eps 1e-8, bias-corrected, no weight decay).

PGD (Madry et al., arXiv:1706.06083) perturbs the batch rows before the
step: from a start in the eps-ball, x <- clamp(clamp(x + alpha sign(d loss
/ d x), x0 - eps, x0 + eps), lo, hi), the loss being the same layer's over
eval-mode (running statistics) features.

At initialisation the layer's loss is chaotic in the features (a 1e-6 move
of unit-norm features changes a few per cent of the neighbour lists and the
loss by several per cent), so a step can *follow* a subject: the graph
layer then runs on the subject's features and lists of that step, and the
reference encoder back-propagates the layer's feature gradient from its
own parameters.  The encoder and the neighbour selection are compared by
themselves.  The encoder is the configuration's (``features(p, x, cfg,
train)`` of its file under ``encoders/``) and computes in float32 with TF32
off, or under bfloat16 autocast for the control; the graph layer in
float64.
"""
from __future__ import annotations

import contextlib

import torch

from . import laplace


@contextlib.contextmanager
def precision(name: str, device):
    """'float32': float32 with TF32 off for convolutions and matrix
    products; 'bfloat16': the encoder under bfloat16 autocast."""
    conv, mm = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if name == "bfloat16":
            with torch.autocast(device_type=torch.device(device).type,
                                dtype=torch.bfloat16):
                yield
        elif name == "float32":
            yield
        else:
            raise ValueError(f"unknown precision {name!r}")
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def select(f: torch.Tensor, k: int, prec: str = "float32") -> torch.Tensor:
    """The neighbour lists of features ``f``, ranked on ``f`` as held in
    ``prec`` (the control ranks bfloat16-rounded features)."""
    if prec == "bfloat16":
        f = f.to(torch.bfloat16)
    return laplace.knn_select(f.float(), k)


def op_loss(f, nbr, base_labels, labels, cfg, keep=None):
    """(loss, d loss / d f) of the graph layer in float64 at features
    ``f`` over lists ``nbr``; ``keep``: the loss over the first ``keep``
    batch rows only (a planted fault: part of the batch left out)."""
    x = f.detach().double().requires_grad_(True)
    y = torch.nn.functional.one_hot(base_labels.long(), cfg["num_classes"])
    with torch.enable_grad():
        pred = laplace.dense_predict(x, y, nbr, cfg["tau"])
        if keep is not None:
            pred, labels = pred[:keep], labels[:keep]
        loss = laplace.ce_loss(pred, labels)
        (g,) = torch.autograd.grad(loss, x)
    return float(loss.detach()), g


def input_grad(features, p, base_x, x, base_labels, labels, cfg,
               prec="float32", follow=None):
    """d loss / d x of the eval-mode graph loss at batch rows ``x``, and
    the (features, lists) the layer ran on: this run's own, or
    ``follow``'s."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        with precision(prec, x.device):
            f = features(p, torch.cat([base_x, x]), cfg, False).float()
        used = follow if follow is not None else (
            f.detach(), select(f.detach(), cfg["knn_k"], prec))
        _, g_f = op_loss(*used, base_labels, labels, cfg)
        (g,) = torch.autograd.grad(f, x, g_f.to(f.dtype))
    return g, used


def pgd_step(x, g, x0, cfg, lo, hi):
    """One PGD iterate from ``x`` with gradient ``g``."""
    eps = cfg["pgd_eps"]
    x = torch.clamp(x + cfg["pgd_alpha"] * torch.sign(g), x0 - eps, x0 + eps)
    return torch.clamp(x, lo, hi)


def train_steps(features, params: dict, buffers: dict, batches, cfg: dict,
                lrs, prec: str = "float32", keep: int | None = None,
                follow=None) -> dict:
    """Steps of the GL update from ``params`` over ``batches`` (each
    (images NCHW, base labels, labels)) at learning rates ``lrs``, the
    encoder being ``features``.

    ``follow``: per step the (features, lists) the graph layer runs on;
    None runs it on this run's own features and lists.  Returns the
    losses, the first step's gradient as the optimizer took it, each
    leaf's change after the steps, each step's (features, lists) that the
    layer ran on, and ``fed``: each step's (parameters and buffers, images,
    own features, train mode)."""
    names = list(params)
    p = {n: t.detach().clone() for n, t in params.items()}
    state: dict = {}
    out = {"losses": [], "grad": None, "used": [], "fed": []}
    for t, ((images, base_labels, labels), lr) in enumerate(
            zip(batches, lrs), start=1):
        leaves = [p[n].requires_grad_(True) for n in names]
        with torch.enable_grad():
            with precision(prec, images.device):
                f = features({**p, **buffers}, images, cfg, True).float()
            used = follow[t - 1] if follow is not None else (
                f.detach(), select(f.detach(), cfg["knn_k"], prec))
            loss, g_f = op_loss(*used, base_labels, labels, cfg, keep)
            grads = torch.autograd.grad(f, leaves, g_f.to(f.dtype),
                                        allow_unused=True)
        grads = [torch.zeros_like(a) if g is None else g
                 for a, g in zip(leaves, grads)]
        out["fed"].append(({n: v.detach().clone() for n, v in
                            {**p, **buffers}.items()}, images, f.detach(),
                           True))
        out["losses"].append(loss)
        out["used"].append(used)
        with torch.no_grad():
            taken = _update(cfg, state, names, p, grads, lr, t)
        if out["grad"] is None:
            out["grad"] = taken
    out["change"] = {n: (p[n] - params[n]).detach() for n in names}
    return out


def _update(cfg, state, names, p, grads, lr, t):
    """One optimizer update of ``p``; returns each leaf's gradient as the
    optimizer took it."""
    taken = {}
    for n, g in zip(names, grads):
        w = p[n].detach()
        if cfg["optimizer"] == "sgd":
            d = g + cfg["weight_decay"] * w
            buf = state.get(n)
            buf = d.clone() if buf is None else cfg["momentum"] * buf + d
            state[n] = buf
            step = lr * buf
        elif cfg["optimizer"] == "adam":
            d = g
            m, v = state.get(n, (torch.zeros_like(w), torch.zeros_like(w)))
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            state[n] = (m, v)
            step = lr * (m / (1 - 0.9 ** t)) / (
                torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
        else:
            raise ValueError(cfg["optimizer"])
        taken[n] = d
        p[n] = w - step
    return taken
