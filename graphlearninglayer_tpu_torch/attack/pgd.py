"""PGD adversarial-training inner loops.

Twin of ``graphlearninglayer_tpu/attack/pgd.py`` (the reference's robust
training loops): a uniform(-eps, eps) start and a range clamp, then
``num_iters`` signed-gradient steps of size ``alpha``, each clamped to the
eps ball and the data range.  The GL variant differentiates the custom-CE
loss of the graph head with respect to the perturbed batch rows of the
base + batch stack: a full graph build, solve and implicit-differentiation
backward per PGD step (6 op calls per optimizer step at 5 iterations).

The start is drawn from an explicit ``torch.Generator`` on the images'
device.  The iterations are :func:`pgd_iterations`, which takes the start,
so a caller can feed any start (the tests feed JAX's).

The JAX package passes the live parameters to its ``*_p`` builders as
arguments, so that one compiled program serves every training step; here
``perturb`` takes the live model instead, and the closure-style builders
close over a callable.  The builders take ``device``: the card unless the
caller passes ``device="cpu"``; without CUDA they raise.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..train.trainer import _to_device, resolve_device
from ..utils.profiling import annotate
from .fgsm import _bound, check_grad_norms, gl_loss, input_grad, nll

__all__ = ["make_gl_pgd_perturb", "make_mlp_pgd_perturb",
           "make_gl_pgd_perturb_p", "make_mlp_pgd_perturb_p",
           "pgd_iterations", "uniform_start"]


def uniform_start(images, eps: float, generator: torch.Generator | None,
                  min_val, max_val) -> torch.Tensor:
    """images + uniform(-eps, eps) noise, clamped to the data range."""
    noise = torch.rand(images.shape, generator=generator,
                       device=images.device, dtype=images.dtype)
    return torch.clamp(images + (2.0 * eps * noise - eps), min_val, max_val)


def pgd_iterations(loss_fn: Callable, start, images, alpha: float,
                   eps: float, num_iters: int, min_val, max_val):
    """``num_iters`` steps from ``start``: data + alpha sign(d loss / d
    data), clamped to [images - eps, images + eps], then to the data
    range."""
    lo, hi = images - eps, images + eps
    data = start
    for _ in range(num_iters):
        g = input_grad(loss_fn, data)
        data = torch.clamp(data + alpha * torch.sign(g), lo, hi)
        data = torch.clamp(data, min_val, max_val)
    return data


def _gl_perturb(encode, num_classes, op_kw, eps, alpha, num_iters, grad_warn,
                dev, base_images, base_labels, images, labels, generator,
                min_val, max_val, stats):
    """The GL attack; the span ``pgd.attack``."""
    with annotate("pgd.attack"):
        base_images, images = _to_device(base_images, dev), \
            _to_device(images, dev)
        base_labels, labels = _to_device(base_labels, dev), \
            _to_device(labels, dev)
        lo, hi = _bound(min_val, images), _bound(max_val, images)
        own = stats is None
        stats = [] if own else stats
        loss = gl_loss(encode, num_classes, op_kw, base_images, base_labels,
                       labels, stats)
        start = uniform_start(images, eps, generator, lo, hi)
        adv = pgd_iterations(loss, start, images, alpha, eps, num_iters, lo,
                             hi)
        if own:
            check_grad_norms(stats, grad_warn)
    return adv


def _mlp_perturb(classify, eps, alpha, num_iters, dev, images, labels,
                 generator, min_val, max_val):
    images, labels = _to_device(images, dev), _to_device(labels, dev)
    lo, hi = _bound(min_val, images), _bound(max_val, images)
    start = uniform_start(images, eps, generator, lo, hi)
    return pgd_iterations(lambda d: nll(classify(d), labels), start, images,
                          alpha, eps, num_iters, lo, hi)


def make_gl_pgd_perturb_p(apply_feats: Callable, num_classes: int,
                          tau: float = 0.0, epsilon_graph="auto",
                          k: int = 25, solver: str = "cholesky",
                          eps: float = 0.3, alpha: float = 0.01,
                          num_iters: int = 40, grad_warn="default",
                          device="cuda"):
    """GL-head PGD against a live model: ``apply_feats(model, images) ->
    features``.  Returns ``perturb(model, base_images, base_labels, images,
    labels, generator, min_val, max_val, stats=None) -> adv_images``.

    ``stats``: a list to which each op call appends its ``stats`` dict (the
    backward's norms), for the caller to check with the step's metrics;
    with None, ``perturb`` checks them itself (``grad_warn``) before it
    returns, which waits for the device."""
    dev = resolve_device(device)
    op_kw = dict(tau=tau, epsilon=epsilon_graph, k=k, solver=solver)

    def perturb(model, base_images, base_labels, images, labels, generator,
                min_val, max_val, stats: list | None = None):
        return _gl_perturb(lambda x: apply_feats(model, x), num_classes,
                           op_kw, eps, alpha, num_iters, grad_warn, dev,
                           base_images, base_labels, images, labels,
                           generator, min_val, max_val, stats)

    return perturb


def make_mlp_pgd_perturb_p(apply_logp: Callable, eps: float = 0.3,
                           alpha: float = 0.01, num_iters: int = 40,
                           device="cuda"):
    """MLP-head PGD against a live model: ``apply_logp(model, images) ->
    log-probs``.  Returns ``perturb(model, images, labels, generator,
    min_val, max_val) -> adv_images``."""
    dev = resolve_device(device)

    def perturb(model, images, labels, generator, min_val, max_val):
        return _mlp_perturb(lambda x: apply_logp(model, x), eps, alpha,
                            num_iters, dev, images, labels, generator,
                            min_val, max_val)

    return perturb


def make_gl_pgd_perturb(encode: Callable, num_classes: int, tau: float = 0.0,
                        epsilon_graph="auto", k: int = 25,
                        solver: str = "cholesky", eps: float = 0.3,
                        alpha: float = 0.01, num_iters: int = 40,
                        grad_warn="default", device="cuda"):
    """Returns ``perturb(base_images, base_labels, images, labels,
    generator, min_val, max_val) -> adv_images``; ``encode(images) ->
    features`` closes over the model, held fixed for the inner loop."""
    dev = resolve_device(device)
    op_kw = dict(tau=tau, epsilon=epsilon_graph, k=k, solver=solver)

    def perturb(base_images, base_labels, images, labels, generator,
                min_val, max_val):
        return _gl_perturb(encode, num_classes, op_kw, eps, alpha, num_iters,
                           grad_warn, dev, base_images, base_labels, images,
                           labels, generator, min_val, max_val, None)

    return perturb


def make_mlp_pgd_perturb(classify: Callable, eps: float = 0.3,
                         alpha: float = 0.01, num_iters: int = 40,
                         device="cuda"):
    """PGD against an MLP head (NLL on log-probs); ``classify(images) ->
    log-probs``.  Returns ``perturb(images, labels, generator, min_val,
    max_val) -> adv_images``."""
    dev = resolve_device(device)

    def perturb(images, labels, generator, min_val, max_val):
        return _mlp_perturb(classify, eps, alpha, num_iters, dev, images,
                            labels, generator, min_val, max_val)

    return perturb
