"""FGSM / IFGSM attacks through the graph Laplace-learning head.

Twin of ``graphlearninglayer_tpu/attack/fgsm.py`` (the reference attack
evaluation):

  * FGSM: one step of size epsilon; IFGSM: int(5 * epsilon / 0.05) steps
    of size alpha = 0.05.
  * Each step differentiates the custom-CE loss with respect to the
    *batch* rows of the base + batch stack: the gradient flows through the
    graph build and solve by ``laplace_learning``'s autograd Function.
  * After every step the images are clamped to the (normalized) data range
    and to the epsilon ball around the originals.

Also the helpers the other attacks share: the graph head's scores of a
base + batch stack, an input gradient, and the exploding-gradient check.
That check reads the op backward's norms (``stats``) on the host once per
attack call, where the JAX op checks inside each backward (its
``grad_warn``).

The builders take ``device``: the card unless the caller passes
``device="cpu"``; without CUDA they raise.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..ops import laplace_learning, warn_exploding_grad
from ..train.losses import custom_ce_loss
from ..train.trainer import _to_device, resolve_device

__all__ = ["fgsm_attack_step", "make_gl_fast_gradient_attack",
           "make_mlp_fast_gradient_attack"]


def fgsm_attack_step(images, step_size, grad, min_val, max_val):
    """One signed-gradient step and the data-range clamp."""
    return torch.clamp(images + step_size * torch.sign(grad), min_val,
                       max_val)


def _num_iters(attack: str, epsilon: float) -> int:
    if attack == "fgsm":
        return 1
    if attack == "ifgsm":
        return max(int(5 * (epsilon / 0.05)), 0)
    raise ValueError("attack must be fgsm or ifgsm")


def _bound(v, like: torch.Tensor) -> torch.Tensor:
    """A clamp bound (a float, or per-channel values shaped to broadcast
    over NCHW) as a tensor on ``like``'s device and dtype."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def gl_scores(encode: Callable, num_classes: int, op_kw: dict, base_images,
              base_labels, images, stats: dict | None = None):
    """The graph head's class scores of the batch rows: encode the base +
    batch stack and run ``laplace_learning`` with the base labels."""
    feats = encode(torch.cat([base_images, images]))
    y = F.one_hot(base_labels.long(), num_classes).to(feats.dtype)
    return laplace_learning(feats, y, stats=stats, **op_kw)


def input_grad(loss_fn: Callable, data: torch.Tensor) -> torch.Tensor:
    """d loss_fn(data) / d data, and no other gradient."""
    data = data.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss_fn(data), data)
    return g


def check_grad_norms(stats: list, grad_warn="default") -> None:
    """Read the op backward's norms (||dL/dP||, ||dL/dX||) from the
    ``stats`` dicts of an attack call's op calls in one transfer, and warn
    as ``warn_exploding_grad`` does on the largest; ``grad_warn=None``
    skips the check."""
    pairs = [torch.stack([s["grad_norm"], s["out_norm"]]) for s in stats
             if "out_norm" in s]
    if grad_warn is None or not pairs:
        return
    big = torch.stack(pairs).amax(0).tolist()
    warn_exploding_grad(big[0], big[1], grad_warn)


def max_chol_info(stats: list) -> int:
    """The largest Cholesky info among op calls' ``stats`` dicts (0 when
    every factorization succeeded), in one transfer."""
    infos = [s["chol_info"] for s in stats if "chol_info" in s]
    return int(torch.stack(infos).max().item()) if infos else 0


def gl_loss(encode, num_classes, op_kw, base_images, base_labels, labels,
            stats: list) -> Callable:
    """``loss(images)``: the custom CE of the graph head's scores.  Each op
    call appends its ``stats`` dict to ``stats``."""

    def loss(images):
        stats.append({})
        pred = gl_scores(encode, num_classes, op_kw, base_images,
                         base_labels, images, stats[-1])
        return custom_ce_loss(pred, labels)

    return loss


def make_gl_fast_gradient_attack(encode: Callable, num_classes: int,
                                 tau: float = 0.0, epsilon_graph="auto",
                                 k: int = 25, solver: str = "cholesky",
                                 grad_warn="default", device="cuda"):
    """Attack builder for GL-head models.

    ``encode(images) -> features`` is the frozen eval-mode network.  Returns
    ``attack(base_images, base_labels, images, labels, eps, kind, min_val,
    max_val, stats=None)`` giving (adv_images, final_pred).  ``grad_warn``:
    the exploding-gradient threshold of the op backward ('default' = the
    module's, None disables).  ``stats``: a list to which each op call
    appends its ``stats`` dict (Cholesky info, the backward's norms), for
    the caller to read with its predictions; with None, ``attack`` checks
    the norms itself before it returns."""
    dev = resolve_device(device)
    op_kw = dict(tau=tau, epsilon=epsilon_graph, k=k, solver=solver)

    def attack(base_images, base_labels, images, labels, eps, kind,
               min_val, max_val, stats: list | None = None):
        iters = _num_iters(kind, float(eps))
        base_images, images = _to_device(base_images, dev), \
            _to_device(images, dev)
        base_labels, labels = _to_device(base_labels, dev), \
            _to_device(labels, dev)
        lo_val, hi_val = _bound(min_val, images), _bound(max_val, images)
        step = eps if kind == "fgsm" else 0.05
        lo, hi = images - eps, images + eps
        own = stats is None
        stats = [] if own else stats
        loss = gl_loss(encode, num_classes, op_kw, base_images, base_labels,
                       labels, stats)
        data = images
        for _ in range(iters):
            g = input_grad(loss, data)
            data = fgsm_attack_step(data, step, g, lo_val, hi_val)
            data = torch.clamp(data, lo, hi)
        stats.append({})
        with torch.no_grad():
            pred = gl_scores(encode, num_classes, op_kw, base_images,
                             base_labels, data, stats[-1])
        if own:
            check_grad_norms(stats, grad_warn)
        return data, torch.argmax(pred, dim=1)

    return attack


def nll(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-mean(sum(onehot * logp)): NLL on log-probabilities."""
    onehot = F.one_hot(labels.long(), logp.shape[1]).to(logp.dtype)
    return -torch.mean(torch.sum(onehot * logp, dim=1))


def make_mlp_fast_gradient_attack(classify: Callable, device="cuda"):
    """Attack builder for MLP-head models; ``classify(images) ->
    log-probs``.  NLL loss on the log-probabilities."""
    dev = resolve_device(device)

    def attack(images, labels, eps, kind, min_val, max_val):
        iters = _num_iters(kind, float(eps))
        images = _to_device(images, dev)
        labels = _to_device(labels, dev)
        lo_val, hi_val = _bound(min_val, images), _bound(max_val, images)
        step = eps if kind == "fgsm" else 0.05
        lo, hi = images - eps, images + eps
        data = images
        for _ in range(iters):
            g = input_grad(lambda d: nll(classify(d), labels), data)
            data = torch.clamp(fgsm_attack_step(data, step, g, lo_val,
                                                hi_val), lo, hi)
        with torch.no_grad():
            pred = torch.argmax(classify(data), dim=1)
        return data, pred

    return attack
