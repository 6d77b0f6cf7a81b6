"""Loss functions: twin of ``graphlearninglayer_tpu/train/losses.py``.

``custom_ce_loss`` is the GL training loss: the graph layer's outputs are
already (approximately) row-stochastic scores, so cross-entropy is taken on
the raw scores with a log clamp and NO softmax.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["custom_ce_loss", "sup_con_loss", "entropy", "logsumexp_loss",
           "l2_loss", "sym_ce_loss"]


def custom_ce_loss(scores: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """CE on probability-like scores: -sum(onehot * log(scores + 1e-8)) / B.
    ``targets`` are integer labels."""
    batch, num_classes = scores.shape
    onehot = F.one_hot(targets.long(), num_classes).to(scores.dtype)
    return -torch.sum(onehot * torch.log(scores + 1e-8)) / batch


def entropy(predictions: torch.Tensor) -> torch.Tensor:
    """Mean per-sample entropy of probability rows."""
    return (-torch.sum(predictions * torch.log(predictions + 1e-8))
            / predictions.shape[0])


def logsumexp_loss(predictions: torch.Tensor) -> torch.Tensor:
    """Mean row-wise logsumexp."""
    return torch.mean(torch.logsumexp(predictions, dim=1))


def l2_loss(predictions: torch.Tensor) -> torch.Tensor:
    """-sum(p^2)/B: maximizes prediction confidence."""
    return -torch.sum(predictions ** 2) / predictions.shape[0]


def sym_ce_loss(pred1: torch.Tensor, pred2: torch.Tensor) -> torch.Tensor:
    """Symmetric CE between two logit sets on each other's argmax
    pseudo-labels (softmax applied inside)."""
    plabel1 = torch.argmax(pred1, dim=1).detach()
    plabel2 = torch.argmax(pred2, dim=1).detach()
    return F.cross_entropy(pred2, plabel1) + F.cross_entropy(pred1, plabel2)


def sup_con_loss(features: torch.Tensor, labels: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None, temperature: float = 0.07,
                 contrast_mode: str = "all",
                 base_temperature: float = 0.07) -> torch.Tensor:
    """Supervised contrastive / SimCLR loss.

    features: (bsz, n_views, dim) unit-norm; labels: (bsz,) ints or None
    (SimCLR mode); mask: optional (bsz, bsz) positives mask.
    """
    if features.dim() < 3:
        raise ValueError("features must be [bsz, n_views, dim]")
    bsz, n_views = features.shape[0], features.shape[1]
    features = features.reshape(bsz, n_views, -1)

    if labels is not None and mask is not None:
        raise ValueError("cannot define both labels and mask")
    if labels is None and mask is None:
        mask = torch.eye(bsz, dtype=features.dtype, device=features.device)
    elif labels is not None:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.T).to(features.dtype)
    else:
        mask = mask.to(features.dtype)

    contrast_feature = features.transpose(0, 1).reshape(bsz * n_views, -1)
    if contrast_mode == "one":
        anchor_feature, anchor_count = features[:, 0], 1
    elif contrast_mode == "all":
        anchor_feature, anchor_count = contrast_feature, n_views
    else:
        raise ValueError(f"unknown mode {contrast_mode}")

    logits = anchor_feature @ contrast_feature.T / temperature
    logits = logits - torch.max(logits, dim=1, keepdim=True).values.detach()
    mask = mask.repeat(anchor_count, n_views)
    logits_mask = 1.0 - torch.eye(bsz * anchor_count, bsz * n_views,
                                  dtype=logits.dtype, device=logits.device)
    mask = mask * logits_mask

    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(torch.sum(exp_logits, dim=1, keepdim=True))
    mean_log_prob_pos = torch.sum(mask * log_prob, dim=1) / torch.sum(mask,
                                                                      dim=1)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return torch.mean(loss.reshape(anchor_count, bsz))
