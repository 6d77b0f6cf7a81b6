"""Carlini-Wagner L2 attack through the graph head.

Twin of ``graphlearninglayer_tpu/attack/cw.py`` (the reference's
``test_cw_attack``): optimize a tanh-space variable w with Adam (lr 0.005)
so that

    loss = ||w_tanh - data||^2 / B + c * sum(relu(max_c P - P_runnerup)) / B

where the runner-up class is fixed from the *initial* prediction.  The GL
variant uses the graph head's scores; the MLP variant exponentiates the
log-probabilities.  For the GL head each iteration is a full KNN-graph
build, solve and implicit-differentiation backward.

``torch.optim.Adam`` places its epsilon as optax's ``adam`` does, outside
the square root of the bias-corrected second moment: lr * m_hat /
(sqrt(v_hat) + 1e-8) (tests/test_torch_attacks.py holds the two against
each other).  The max over classes and the hinge split their gradient over
ties as ``jnp.max`` and ``jnp.maximum`` do (``torch.amax``,
``torch.maximum``).

The builders take ``device``: the card unless the caller passes
``device="cpu"``; without CUDA they raise.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..train.trainer import _to_device, resolve_device
from .fgsm import _bound, check_grad_norms, gl_scores, input_grad

__all__ = ["make_gl_cw_attack", "make_mlp_cw_attack"]


def _to_tanh_space(data, min_val, max_val):
    return torch.atanh(torch.clamp(
        (2.0 / (max_val - min_val)) * (data - min_val) - 1.0,
        -1 + 1e-6, 1 - 1e-6))


def _from_tanh_space(w, min_val, max_val):
    return 0.5 * (torch.tanh(w) + 1.0) * (max_val - min_val) + min_val


def _cw_margin(output, idx, next_pred, c, batch):
    gap = torch.amax(output, dim=1) - output[idx, next_pred]
    return c * torch.sum(torch.maximum(gap, torch.zeros_like(gap))) / batch


def _cw(output_fn: Callable, images, c, min_val, max_val, cw_lr: float,
        iters: int):
    """Adam on w from the images' tanh-space point; returns (adv,
    init_pred, final_pred)."""
    batch = images.shape[0]
    idx = torch.arange(batch, device=images.device)
    lo, hi = _bound(min_val, images), _bound(max_val, images)
    with torch.no_grad():
        init_out = output_fn(images)
    init_pred = torch.argmax(init_out, dim=1)
    masked = init_out.clone()
    masked[idx, init_pred] = -1e6
    next_pred = torch.argmax(masked, dim=1)

    def loss_fn(w):
        w_tanh = _from_tanh_space(w, lo, hi)
        loss1 = torch.sum((w_tanh - images) ** 2) / batch
        return loss1 + _cw_margin(output_fn(w_tanh), idx, next_pred, c,
                                  batch)

    w = _to_tanh_space(images, lo, hi).requires_grad_(True)
    opt = torch.optim.Adam([w], lr=cw_lr)
    for _ in range(iters):
        w.grad = input_grad(loss_fn, w)
        opt.step()
    adv = _from_tanh_space(w.detach(), lo, hi)
    with torch.no_grad():
        final_pred = torch.argmax(output_fn(adv), dim=1)
    return adv, init_pred, final_pred


def make_gl_cw_attack(encode: Callable, num_classes: int, tau: float = 0.0,
                      epsilon_graph="auto", k: int = 25,
                      solver: str = "cholesky", cw_lr: float = 0.005,
                      iters: int = 100, grad_warn="default", device="cuda"):
    """CW attack for GL-head models; ``encode(images) -> features``.
    Returns ``attack(base_images, base_labels, images, c, min_val,
    max_val, stats=None)`` giving (adv_images, init_pred, final_pred);
    ``stats`` as in ``make_gl_fast_gradient_attack``."""
    dev = resolve_device(device)
    op_kw = dict(tau=tau, epsilon=epsilon_graph, k=k, solver=solver)

    def attack(base_images, base_labels, images, c, min_val, max_val,
               stats: list | None = None):
        base_images, images = _to_device(base_images, dev), \
            _to_device(images, dev)
        base_labels = _to_device(base_labels, dev)
        own = stats is None
        stats = [] if own else stats

        def output(x):
            stats.append({})
            return gl_scores(encode, num_classes, op_kw, base_images,
                             base_labels, x, stats[-1])

        out = _cw(output, images, c, min_val, max_val, cw_lr, iters)
        if own:
            check_grad_norms(stats, grad_warn)
        return out

    return attack


def make_mlp_cw_attack(classify: Callable, cw_lr: float = 0.005,
                       iters: int = 100, device="cuda"):
    """CW attack for MLP-head models; ``classify(images) -> log-probs``.
    Returns ``attack(images, c, min_val, max_val)`` giving (adv_images,
    init_pred, final_pred)."""
    dev = resolve_device(device)

    def attack(images, c, min_val, max_val):
        return _cw(lambda x: torch.exp(classify(x)), _to_device(images, dev),
                   c, min_val, max_val, cw_lr, iters)

    return attack
