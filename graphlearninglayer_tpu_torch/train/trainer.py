"""GL train and eval steps.

Twin of ``graphlearninglayer_tpu/train/trainer.py``.

One step runs the encoder forward, the graph Laplace-learning head, the loss,
the hand-derived backward and the optimizer update on the device.  The step
returns device tensors and never waits for the device: read its metrics on
the host with :func:`metrics_to_host` where a driver flushes them, which is
also where the exploding-gradient warning is raised.

Batches arrive as uint8 NHWC arrays (numpy or tensors), exactly as the JAX
steps take them, and are normalized on the device.

The entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA they raise rather than move to the CPU on their own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import laplace_learning, warn_exploding_grad
from .losses import custom_ce_loss
from .optim import make_optimizer

__all__ = ["TrainState", "create_train_state", "params_finite",
           "resolve_device", "make_gl_train_step", "make_gl_eval_step",
           "make_mlp_train_step", "make_mlp_eval_step", "make_encode_step",
           "metrics_to_host"]


@dataclass
class TrainState:
    """Model (parameters and BN statistics), optimizer, LR scheduler and the
    count of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA when no CUDA device
    is present instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def create_train_state(model: nn.Module, schedule: Callable[[int], float],
                       device="cuda", adam: bool = False,
                       momentum: float = 0.9,
                       weight_decay: float = 5e-4) -> TrainState:
    """Move ``model`` to ``device`` and build its optimizer and scheduler
    (see ``optim.make_optimizer``)."""
    model = model.to(resolve_device(device))
    optimizer, scheduler = make_optimizer(model.parameters(), schedule, adam,
                                          momentum, weight_decay)
    return TrainState(model, optimizer, scheduler, 0)


def params_finite(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """Device bool scalar: every parameter entry is finite (the reference
    sweeps all model params for NaN after every optimizer step)."""
    flags = [torch.isfinite(p).all() for p in params]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def _to_device(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)  # torch takes no negative strides
    return torch.as_tensor(a).to(device, non_blocking=True)


def _device_normalize(x: torch.Tensor, norm) -> torch.Tensor:
    """uint8 NHWC batch -> normalized float32 NCHW on x's device.

    ``norm=(mean, std)`` per channel; ``norm=None`` expects already-
    normalized float NHWC input.  Same formula as the JAX package's
    ``data/augment.py::normalize_batch``, in float32."""
    if norm is not None:
        mean, std = norm
        x = x.float() / 255.0
        x = ((x - torch.as_tensor(mean, dtype=torch.float32, device=x.device))
             / torch.as_tensor(std, dtype=torch.float32, device=x.device))
    return x.permute(0, 3, 1, 2)


def _scores(pred: torch.Tensor, labels: torch.Tensor,
            score_type: str) -> torch.Tensor:
    """Per-sample uncertainty scores for base-set selection: 'entropy' =
    per-sample CE, 'l2' = 1 - ||p||^2."""
    if score_type == "entropy":
        onehot = F.one_hot(labels, pred.shape[1]).to(pred.dtype)
        return -torch.sum(onehot * torch.log(pred + 1e-8), dim=1)
    if score_type == "l2":
        return 1.0 - torch.sum(pred ** 2, dim=1)
    raise ValueError(score_type)


def _zero_grads(model: nn.Module) -> None:
    # Every parameter gets a gradient tensor, zero where the loss does not
    # reach it (the aux classifier in GL mode), so that weight decay and
    # momentum move it as the JAX package's optax chain does.
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()


def make_gl_train_step(num_classes: int, tau: float, epsilon="auto",
                       k: int = 25, solver: str = "cholesky",
                       score_type: str = "entropy", norm=None,
                       device="cuda") -> Callable:
    """GL-branch step: stack base on top of the batch, encode, run the graph
    head with base labels, CE on batch labels, one optimizer update.

    ``step(state, base_images, base_labels, images, labels)`` returns
    ``(state, metrics, scores)``.  ``metrics`` holds device scalars:
    ``loss``, ``acc``, ``params_finite``, ``grad_norm`` and ``out_norm``
    (the op backward's ||dL/dP|| and ||dL/dX||), and ``chol_info`` (0 when
    the Cholesky factorization succeeded) or, with ``solver='cg'``,
    ``cg_iters`` (forward plus adjoint CG iterations).
    ``norm=(mean, std)``: accept uint8 batches and normalize on the
    device."""
    dev = resolve_device(device)

    def step(state: TrainState, base_images, base_labels, images, labels):
        model = state.model
        model.train()
        x = _device_normalize(torch.cat([_to_device(base_images, dev),
                                         _to_device(images, dev)]), norm)
        labels = _to_device(labels, dev).long()
        y = F.one_hot(_to_device(base_labels, dev).long(),
                      num_classes).to(x.dtype)

        stats: dict = {}
        _, features = model(x)
        pred = laplace_learning(features, y, tau=tau, epsilon=epsilon, k=k,
                                solver=solver, stats=stats)
        loss = custom_ce_loss(pred, labels)
        _zero_grads(model)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1

        pred = pred.detach()
        acc = torch.mean((torch.argmax(pred, dim=1) == labels).float())
        metrics = {"loss": loss.detach(), "acc": acc,
                   "params_finite": params_finite(model.parameters()),
                   "grad_norm": stats["grad_norm"],
                   "out_norm": stats["out_norm"]}
        if "chol_info" in stats:
            metrics["chol_info"] = stats["chol_info"]
        else:
            metrics["cg_iters"] = torch.tensor(
                stats["cg_iters"] + stats["cg_iters_bwd"], device=dev)
        return state, metrics, _scores(pred, labels, score_type)

    return step


def make_mlp_train_step(norm=None, device="cuda") -> Callable:
    """MLP-branch step: the aux classifier head's probability outputs, the
    custom CE on them, one optimizer update.  ``step(state, images,
    labels)`` returns ``(state, metrics)`` with device scalars ``loss``,
    ``acc`` and ``params_finite``.  ``norm``: see make_gl_train_step."""
    dev = resolve_device(device)

    def step(state: TrainState, images, labels):
        model = state.model
        model.train()
        x = _device_normalize(_to_device(images, dev), norm)
        labels = _to_device(labels, dev).long()
        pred, _ = model(x)
        loss = custom_ce_loss(pred, labels)
        _zero_grads(model)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        acc = torch.mean((torch.argmax(pred.detach(), dim=1)
                          == labels).float())
        return state, {"loss": loss.detach(), "acc": acc,
                       "params_finite": params_finite(model.parameters())}

    return step


def make_gl_eval_step(num_classes: int, tau: float, epsilon="auto",
                      k: int = 25, solver: str = "cholesky", norm=None,
                      device="cuda") -> Callable:
    """test_network equivalent: classify a test batch by running the network
    + graph head against one base batch.  ``step(state, base_images,
    base_labels, images)`` returns the predicted classes (device int64)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(state: TrainState, base_images, base_labels, images):
        model = state.model
        model.eval()
        x = _device_normalize(torch.cat([_to_device(base_images, dev),
                                         _to_device(images, dev)]), norm)
        y = F.one_hot(_to_device(base_labels, dev).long(),
                      num_classes).to(x.dtype)
        _, features = model(x)
        pred = laplace_learning(features, y, tau=tau, epsilon=epsilon, k=k,
                                solver=solver)
        return torch.argmax(pred, dim=1)

    return step


def make_mlp_eval_step(norm=None, device="cuda") -> Callable:
    """test_network's MLP predictor: classify a test batch with the aux
    classifier head alone.  ``step(state, images)`` returns the predicted
    classes (device int64)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(state: TrainState, images):
        model = state.model
        model.eval()
        pred, _ = model(_device_normalize(_to_device(images, dev), norm))
        return torch.argmax(pred, dim=1)

    return step


def make_encode_step(norm=None, device="cuda") -> Callable:
    """Feature-extraction step (the reference's loader_to_numpy): the
    encoder in eval mode (BN running statistics), the L2-normalized
    features only.  ``step(state, images)`` returns the (B, feat_dim)
    features on the device.  ``norm=(mean, std)``: accept uint8 batches and
    normalize on the device.  The batch is cast to the parameters' dtype, so
    a float64 model (on the CPU) gives float64 features."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(state: TrainState, images):
        model = state.model
        model.eval()
        x = _device_normalize(_to_device(images, dev), norm)
        _, features = model(x.to(next(model.parameters()).dtype))
        return features

    return step


def metrics_to_host(metrics: dict) -> dict:
    """Copy a step's device metrics to the host in one transfer and run the
    exploding-gradient check on them (``ops.warn_exploding_grad`` with the
    module threshold)."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().double().reshape(())
                        for k in keys]).cpu().tolist()
    out = dict(zip(keys, vals))
    if "params_finite" in out:
        out["params_finite"] = bool(out["params_finite"])
    for key in ("chol_info", "cg_iters"):
        if key in out:
            out[key] = int(out[key])
    if "out_norm" in out:
        warn_exploding_grad(out.get("grad_norm"), out["out_norm"])
    return out
