"""Synthetic datasets and per-dataset channel statistics.

The port's own copy of the offline parts of the JAX package's
``data/datasets.py`` (``DatasetSpec``, ``_smooth_basis``,
``synthetic_dataset``) and of ``CHANNEL_STATS`` from its ``data/augment.py``.
The same seed and arguments give byte-identical images and labels, so a
learnable batch at CIFAR geometry exists without any dataset files.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CHANNEL_STATS", "DatasetSpec", "synthetic_dataset"]

# ToTensor+Normalize stats per dataset (reference config/datasets_setting.py)
CHANNEL_STATS = {
    "mnist": ([0.1307], [0.3081]),
    "fashion_mnist": ([0.2860], [0.3530]),
    "cifar10": ([0.4914, 0.4822, 0.4465], [0.2470, 0.2435, 0.2616]),
    "cifar100": ([0.5071, 0.4867, 0.4408], [0.2675, 0.2565, 0.2761]),
    "miniimagenet": ([120.39586422 / 255, 115.59361427 / 255,
                      104.54012653 / 255],
                     [70.68188272 / 255, 68.27635443 / 255,
                      72.54505529 / 255]),
    "synthetic": ([0.5], [0.5]),
}


@dataclass
class DatasetSpec:
    name: str
    train_images: np.ndarray  # uint8 NHWC
    train_labels: np.ndarray  # int64 N
    test_images: np.ndarray
    test_labels: np.ndarray
    num_classes: int

    @property
    def image_shape(self):
        return self.train_images.shape[1:]


def _smooth_basis(rng, latent_dim, h, w, c):
    """Orthonormal basis of smooth low-frequency spatial patterns.

    Each basis vector is a random sin*cos product, Gram-Schmidt
    orthonormalized over the flattened pixel space so the latent code is
    linearly recoverable from the image.
    """
    vecs = []
    while len(vecs) < latent_dim:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        fx, fy = rng.uniform(0.5, 4.0, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        t = np.sin(2 * np.pi * fx * xx / w + px) * np.cos(
            2 * np.pi * fy * yy / h + py)
        v = np.repeat(t[:, :, None], c, axis=2).ravel()
        for u in vecs:
            v = v - (v @ u) * u
        nrm = float(np.linalg.norm(v))
        if nrm < 1e-3:          # degenerate draw (parallel to span): retry
            continue
        vecs.append((v / nrm).astype(np.float32))
    return np.stack(vecs)       # (latent_dim, h*w*c)


def synthetic_dataset(num_classes: int = 10, image_shape=(28, 28, 1),
                      n_train: int = 4096, n_test: int = 1024,
                      seed: int = 0, class_sep: float | None = None,
                      modes_per_class: int = 3, label_noise: float = 0.0,
                      noise_std: float = 0.35,
                      latent_dim: int = 16) -> DatasetSpec:
    """Learnable synthetic image classes.

    * **legacy** (``class_sep=None``): each class is one distinct smooth
      spatial pattern plus pixel noise; cleanly separable.
    * **hard** (``class_sep`` set): a latent Gaussian mixture of
      ``modes_per_class`` modes per class, rendered through an orthonormal
      smooth-pattern basis; ``class_sep`` scales the distance between class
      centers, ``label_noise`` flips that fraction of TRAIN labels, and
      ``noise_std`` is the pixel noise.
    """
    rng = np.random.default_rng(seed)
    h, w, c = image_shape

    if class_sep is not None:
        basis = _smooth_basis(rng, latent_dim, h, w, c)  # (D, h*w*c)
        amp = 0.22 * np.sqrt(h * w * c / latent_dim)
        centers = rng.normal(0, 1, (num_classes, latent_dim))
        offsets = rng.normal(0, 0.5, (num_classes, modes_per_class,
                                      latent_dim))
        mode_mu = class_sep * (centers[:, None, :] + offsets)  # (l, M, D)

        def make(n, seed_off, with_label_noise):
            r = np.random.default_rng(seed + seed_off)
            labels = r.integers(0, num_classes, n)
            modes = r.integers(0, modes_per_class, n)
            z = mode_mu[labels, modes] + r.normal(0, 1, (n, latent_dim))
            img = (z.astype(np.float32) @ basis) * amp
            img = img.reshape(n, h, w, c)
            # per-sample spatial jitter, so no two samples are
            # pixel-identical (coincident features lose their edges)
            shifts = r.integers(-2, 3, size=(n, 2))
            img = np.stack([np.roll(b, tuple(s), axis=(0, 1))
                            for b, s in zip(img, shifts)])
            img = img + r.normal(0, noise_std, img.shape).astype(np.float32)
            img = (img + 1.5) / 3.0
            if with_label_noise and label_noise > 0:
                flip = r.random(n) < label_noise
                labels = np.where(
                    flip, (labels + r.integers(1, num_classes, n))
                    % num_classes, labels)
            return (np.clip(img, 0, 1) * 255).astype(np.uint8), labels

        tri, trl = make(n_train, 1, True)
        tei, tel = make(n_test, 2, False)
        return DatasetSpec("synthetic", tri, trl, tei, tel, num_classes)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    templates = []
    for _ in range(num_classes):
        fx, fy = rng.uniform(0.5, 3.0, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        t = np.sin(2 * np.pi * fx * xx / w + px) * np.cos(
            2 * np.pi * fy * yy / h + py)
        templates.append(np.repeat(t[:, :, None], c, axis=2))
    templates = np.stack(templates)  # (l, h, w, c)

    def make(n, seed_off):
        r = np.random.default_rng(seed + seed_off)
        labels = r.integers(0, num_classes, n)
        base = templates[labels]
        shifts = r.integers(-2, 3, size=(n, 2))
        base = np.stack([np.roll(b, tuple(s), axis=(0, 1))
                         for b, s in zip(base, shifts)])
        noise = r.normal(0, noise_std, base.shape).astype(np.float32)
        img = (base + noise + 1.5) / 3.0
        return (np.clip(img, 0, 1) * 255).astype(np.uint8), labels

    tri, trl = make(n_train, 1)
    tei, tel = make(n_test, 2)
    if label_noise > 0:
        r = np.random.default_rng(seed + 3)
        flip = r.random(n_train) < label_noise
        trl = np.where(flip, (trl + r.integers(1, num_classes, n_train))
                       % num_classes, trl)
    return DatasetSpec("synthetic", tri, trl, tei, tel, num_classes)
