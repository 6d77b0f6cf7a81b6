"""Pseudo-label machinery for semi-supervised extensions.

Twin of ``graphlearninglayer_tpu/data/pseudo_label.py``, the port's own copy
of that numpy module: per-sample predicted outputs and pseudo-labels with
per-class confidence thresholds, where samples below their threshold carry
the label -1 (ignored), and the curriculum thresholds of the reference's
``--cpl`` flag family.  The reference ships this machinery with no driver
wired to it; it is provided for the same extension surface.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PseudoLabelStore", "convert_outputs_to_pseudo_labels"]


def convert_outputs_to_pseudo_labels(outputs: np.ndarray,
                                     thresh) -> np.ndarray:
    """Argmax labels where the max probability clears the (per-class)
    threshold, -1 otherwise."""
    outputs = np.asarray(outputs)
    n_classes = outputs.shape[1]
    thresh = (np.full(n_classes, float(thresh))
              if np.isscalar(thresh) else np.asarray(thresh))
    if thresh.shape[0] != n_classes:
        raise ValueError(
            "Length of thresh does not match the number of classes")
    max_idx = np.argmax(outputs, axis=1)
    max_val = outputs[np.arange(len(outputs)), max_idx]
    labels = np.where(max_val > thresh[max_idx], max_idx, -1)
    return labels.astype(np.int64)


class PseudoLabelStore:
    """Per-sample pseudo-label state over a dataset of size n:
    ``pred_outputs`` (n, l) probabilities, ``pred_labels`` (n,) in
    {-1, 0..l-1}, per-class ``thresh``.  Curriculum updates (FlexMatch
    style) adjust the per-class thresholds from the current pseudo-label
    counts."""

    def __init__(self, n: int, num_classes: int, thresh: float = 0.9):
        self.num_classes = num_classes
        self.pred_outputs = np.zeros((n, num_classes), np.float32)
        self.pred_labels = np.full(n, -1, np.int64)
        self.thresh = np.full(num_classes, float(thresh), np.float32)

    def update_outputs(self, indices: np.ndarray, outputs: np.ndarray):
        self.pred_outputs[indices] = outputs

    def update_labels(self, indices: np.ndarray, labels: np.ndarray):
        self.pred_labels[indices] = labels

    def update_thresh(self, new_thresh):
        self.thresh = (np.full(self.num_classes, float(new_thresh),
                               np.float32)
                       if np.isscalar(new_thresh)
                       else np.asarray(new_thresh, np.float32))

    def update_all_plabels(self):
        self.pred_labels = convert_outputs_to_pseudo_labels(
            self.pred_outputs, self.thresh)

    def curriculum_thresholds(self, base_thresh: float,
                              nonlinear: bool = False,
                              warmup: bool = False) -> np.ndarray:
        """Curriculum pseudo-labeling thresholds: scale each class's
        threshold by its relative learning effect sigma_c = count_c /
        max_c counts, optionally through the nonlinear mapping x / (2 - x)
        and with the unused pool as a warmup denominator."""
        counts = np.bincount(self.pred_labels[self.pred_labels >= 0],
                             minlength=self.num_classes).astype(np.float64)
        denom = counts.max()
        if warmup:
            unused = float(np.sum(self.pred_labels < 0))
            denom = max(denom, unused)
        sigma = counts / max(denom, 1.0)
        if nonlinear:
            sigma = sigma / (2.0 - sigma)
        self.thresh = (base_thresh * sigma).astype(np.float32)
        return self.thresh

    def mask(self) -> np.ndarray:
        """Boolean mask of samples with a confident pseudo-label."""
        return self.pred_labels >= 0
