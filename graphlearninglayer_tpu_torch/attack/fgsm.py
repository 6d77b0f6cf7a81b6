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

Given a mesh (``parallel/mesh.py``), the GL attack shards its rows over
the mesh's ranks, the port's form of the JAX attack run on inputs placed
on a mesh, which GSPMD shards: each rank encodes its blocks of the base and
the batch, and steps and clamps its own batch rows; every rank returns the
whole result.  Without one it runs on one device, where the blocks are the
whole base and batch (``gl_head``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import laplace_learning, warn_exploding_grad
from ..parallel.mesh import Mesh, RowShard
from ..train.losses import custom_ce_loss
from ..train.trainer import _to_device, resolve_device
from ..utils.profiling import annotate, host_sync

__all__ = ["fgsm_attack_step", "make_gl_fast_gradient_attack",
           "make_sharded_gl_fast_gradient_attack",
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


def gl_head(encode: Callable, num_classes: int, op_kw: dict, base_images,
            base_labels, n_batch: int, mesh: Mesh | None = None):
    """The graph head of a base + batch stack of ``n_batch`` batch rows,
    with its rows sharded over ``mesh``'s ranks (None: one device).

    Returns ``(scores, batch)``.  ``batch`` is the ``RowShard`` of the
    batch rows: this rank's are ``batch.lo:batch.hi``.  ``scores(own,
    stats=None)`` takes those rows of the batch images and gives the
    head's class scores of the whole batch.  The base and the batch are
    each split over the ranks, as the JAX attack's inputs placed on a mesh
    are: rank r encodes its block of the base and its block of the batch
    in one call, the features of every rank are gathered with
    ``gather_rows`` into the base + batch order, and every rank runs
    ``laplace_learning`` on all of them with the base labels.  So every
    rank computes the same scores, and their gradient with respect to
    ``own`` is the unsharded gradient's rows (``gather_rows``' backward
    takes this rank's slice).  Without a mesh a lone one stands in: the
    blocks are the whole base and batch, and the gathers the identity."""
    if mesh is None:
        mesh = Mesh(("data",), np.arange(1), base_images.device)
    base, batch = RowShard(mesh, len(base_images)), RowShard(mesh, n_batch)
    own_base = base_images[base.lo:base.hi]

    def scores(own, stats: dict | None = None):
        with annotate("gl.encode"):
            feats = encode(torch.cat([own_base, own]))
        feats = torch.cat([base.gather(feats[:len(own_base)]),
                           batch.gather(feats[len(own_base):])])
        y = F.one_hot(base_labels.long(), num_classes).to(feats.dtype)
        return laplace_learning(feats, y, stats=stats, **op_kw)

    return scores, batch


def gl_scores(encode: Callable, num_classes: int, op_kw: dict, base_images,
              base_labels, images, stats: dict | None = None):
    """The graph head's class scores of the batch rows on one device:
    encode the base + batch stack and run ``laplace_learning`` with the
    base labels."""
    scores, _ = gl_head(encode, num_classes, op_kw, base_images,
                        base_labels, len(images))
    return scores(images, stats)


def input_grad(loss_fn: Callable, data: torch.Tensor) -> torch.Tensor:
    """d loss_fn(data) / d data, and no other gradient; the backward is
    the span ``gl.backward``."""
    data = data.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(data)
        with annotate("gl.backward"):
            (g,) = torch.autograd.grad(loss, data)
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
    host_sync("fgsm.grad_norms")
    big = torch.stack(pairs).amax(0).tolist()
    warn_exploding_grad(big[0], big[1], grad_warn)


def max_chol_info(stats: list) -> int:
    """The largest Cholesky info among op calls' ``stats`` dicts (0 when
    every factorization succeeded), in one transfer."""
    infos = [s["chol_info"] for s in stats if "chol_info" in s]
    if not infos:
        return 0
    host_sync("fgsm.chol_info")
    return int(torch.stack(infos).max().item())


def _ce_loss(scores: Callable, labels, stats: list) -> Callable:
    def loss(own):
        stats.append({})
        return custom_ce_loss(scores(own, stats[-1]), labels)

    return loss


def gl_loss(encode, num_classes, op_kw, base_images, base_labels, labels,
            stats: list, mesh: Mesh | None = None) -> Callable:
    """``loss(own)``: the custom CE of the graph head's scores, ``own`` this
    rank's rows of the batch images (see ``gl_head``; all of them without
    a mesh).  Each op call appends its ``stats`` dict to ``stats``."""
    scores, _ = gl_head(encode, num_classes, op_kw, base_images, base_labels,
                        len(labels), mesh)
    return _ce_loss(scores, labels, stats)


def make_gl_fast_gradient_attack(encode: Callable, num_classes: int,
                                 tau: float = 0.0, epsilon_graph="auto",
                                 k: int = 25, solver: str = "cholesky",
                                 grad_warn="default", device="cuda",
                                 mesh: Mesh | None = None):
    """Attack builder for GL-head models.

    ``encode(images) -> features`` is the frozen eval-mode network.  Returns
    ``attack(base_images, base_labels, images, labels, eps, kind, min_val,
    max_val, stats=None)`` giving (adv_images, final_pred).  ``grad_warn``:
    the exploding-gradient threshold of the op backward ('default' = the
    module's, None disables).  ``stats``: a list to which each op call
    appends its ``stats`` dict (Cholesky info, the backward's norms), for
    the caller to read with its predictions; with None, ``attack`` checks
    the norms itself before it returns.

    ``mesh``: shard the rows over the mesh's ranks (``gl_head``).  Every
    rank takes the whole base and batch and returns the whole result; the
    dense op runs on the gathered features on every rank (K1 on every
    rank, once an op call).  The sign step, the data-range clamp and the
    epsilon-ball clamp act on the rank's own batch rows, which stay the
    unsharded attack's rows, since their gradient is; one gather of the
    adversarial rows at the end, and the final prediction through the op.
    The mesh's device is the attack's, in place of ``device``.  ``encode``
    is the frozen eval-mode network on that device: in eval mode BatchNorm
    reads its running statistics, so no statistics cross the ranks.  The
    norms ``attack`` checks are the same on every rank."""
    dev = resolve_device(device if mesh is None else mesh.device)
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
        own = stats is None
        stats = [] if own else stats
        scores, batch = gl_head(encode, num_classes, op_kw, base_images,
                                base_labels, len(labels), mesh)
        loss = _ce_loss(scores, labels, stats)
        data = images[batch.lo:batch.hi]
        lo, hi = data - eps, data + eps
        for _ in range(iters):
            g = input_grad(loss, data)
            data = fgsm_attack_step(data, step, g, lo_val, hi_val)
            data = torch.clamp(data, lo, hi)
        stats.append({})
        with torch.no_grad():
            pred = scores(data, stats[-1])
            adv = batch.gather(data)
        if own:
            check_grad_norms(stats, grad_warn)
        return adv, torch.argmax(pred, dim=1)

    return attack


def make_sharded_gl_fast_gradient_attack(encode: Callable, num_classes: int,
                                         mesh: Mesh, **kw):
    """:func:`make_gl_fast_gradient_attack` with its rows sharded over the
    ranks of ``mesh``; ``kw`` as there (``tau``, ``epsilon_graph``, ``k``,
    ``solver``, ``grad_warn``)."""
    return make_gl_fast_gradient_attack(encode, num_classes, mesh=mesh, **kw)


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
