"""Host-side image augmentation: the PIL backend and its parameters.

Twin of ``graphlearninglayer_tpu/data/augment.py``: a 14-op RandAugment with
an always-applied random Cutout (<= 0.5 of the width, gray fill), random
rotation / crop-with-padding / horizontal flip, and per-dataset channel
normalization.  Images flow as uint8 HWC numpy arrays; ``normalize``
converts to float32 NHWC in [0, 1] minus mean over std.

PIL is imported only inside the PIL backend (``Transform.__call__`` and the
ops it applies), so this module, and the native backend that reads a
``Transform``'s parameters, work on a machine without PIL.
"""
from __future__ import annotations

import numpy as np

from .datasets import CHANNEL_STATS

__all__ = ["RandAugment", "Transform", "CHANNEL_STATS", "normalize_batch",
           "Lighting", "cutout_default"]


def _affine(img, coeffs):
    import PIL.Image

    return img.transform(img.size, PIL.Image.AFFINE, coeffs)


def _shear_x(img, v, rng):
    v = -v if rng.random() > 0.5 else v
    return _affine(img, (1, v, 0, 0, 1, 0))


def _shear_y(img, v, rng):
    v = -v if rng.random() > 0.5 else v
    return _affine(img, (1, 0, 0, v, 1, 0))


def _translate_x(img, v, rng):
    v = -v if rng.random() > 0.5 else v
    return _affine(img, (1, 0, v * img.size[0], 0, 1, 0))


def _translate_y(img, v, rng):
    v = -v if rng.random() > 0.5 else v
    return _affine(img, (1, 0, 0, 0, 1, v * img.size[1]))


def _rotate(img, v, rng):
    return img.rotate(-v if rng.random() > 0.5 else v)


def _ops(name):
    import PIL.ImageOps

    return getattr(PIL.ImageOps, name)


def _enhance(name):
    import PIL.ImageEnhance

    return getattr(PIL.ImageEnhance, name)


def _posterize(img, v, rng):
    return _ops("posterize")(img, max(1, int(v)))


# (op, minval, maxval), the reference's augment list
_AUGMENT_LIST = [
    (lambda im, v, r: _ops("autocontrast")(im), 0, 1),
    (lambda im, v, r: _enhance("Brightness")(im).enhance(v), 0.05, 0.95),
    (lambda im, v, r: _enhance("Color")(im).enhance(v), 0.05, 0.95),
    (lambda im, v, r: _enhance("Contrast")(im).enhance(v), 0.05, 0.95),
    (lambda im, v, r: _ops("equalize")(im), 0, 1),
    (lambda im, v, r: im, 0, 1),  # Identity
    (_posterize, 4, 8),
    (_rotate, 0, 30),
    (lambda im, v, r: _enhance("Sharpness")(im).enhance(v), 0.05, 0.95),
    (_shear_x, 0.0, 0.3),
    (_shear_y, 0.0, 0.3),
    (lambda im, v, r: _ops("solarize")(im, v), 0, 256),
    (_translate_x, 0.0, 0.3),
    (_translate_y, 0.0, 0.3),
]


def _cutout(img, frac: float, rng):
    """Random gray-filled square occlusion."""
    import PIL.ImageDraw

    if frac <= 0:
        return img
    v = frac * img.size[0]
    w, h = img.size
    x0 = max(0, rng.uniform(0, w) - v / 2.0)
    y0 = max(0, rng.uniform(0, h) - v / 2.0)
    xy = (int(x0), int(y0), int(min(w, x0 + v)), int(min(h, y0 + v)))
    fill = (125, 123, 114) if img.mode == "RGB" else 125
    img = img.copy()
    PIL.ImageDraw.Draw(img).rectangle(xy, fill)
    return img


class RandAugment:
    """n random ops from the 14-op list + an always-applied random
    Cutout."""

    def __init__(self, n: int):
        self.n = n

    def __call__(self, img, rng: np.random.Generator):
        for _ in range(self.n):
            op, lo, hi = _AUGMENT_LIST[rng.integers(len(_AUGMENT_LIST))]
            v = rng.uniform(0, 1) * (hi - lo) + lo
            img = op(img, v, rng)
        return _cutout(img, rng.uniform(0, 1) * 0.5, rng)


class Transform:
    """Per-dataset weak/strong/eval transform.

    mode='weak'   : rotation/flip + padded random crop + RandAugment(1)
    mode='strong' : same with larger rotation + RandAugment(2)
    mode='eval'   : normalization only
    """

    def __init__(self, dataset: str, mode: str = "eval"):
        self.dataset = dataset
        self.mode = mode
        self.mean, self.std = CHANNEL_STATS[dataset]
        grayscale = dataset in ("mnist", "fashion_mnist", "synthetic")
        self.grayscale = grayscale
        if mode == "eval":
            self.rand = None
        else:
            self.rand = RandAugment(1 if mode == "weak" else 2)
        self.rotation = (10 if mode == "weak" else 20) if grayscale else 0
        self.flip = not grayscale and mode != "eval"
        # miniimagenet crops 84x84 with padding 8; the 32x32/28x28 datasets
        # use padding 4
        pad = 8 if dataset == "miniimagenet" else 4
        self.pad = pad if mode != "eval" else 0
        self.pad_mode = "constant" if grayscale else "reflect"

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """The PIL backend.  img: uint8 HWC (C=1 or 3).  Returns uint8
        HWC."""
        if self.mode == "eval":
            return img
        import PIL.Image

        pil = PIL.Image.fromarray(img.squeeze(-1) if self.grayscale else img)
        if self.rotation:
            pil = pil.rotate(rng.uniform(-self.rotation, self.rotation))
        if self.flip and rng.random() < 0.5:
            pil = _ops("mirror")(pil)
        arr = np.asarray(pil)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        arr = self._random_crop(arr, rng)
        pil = PIL.Image.fromarray(arr.squeeze(-1) if self.grayscale else arr)
        pil = self.rand(pil, rng)
        out = np.asarray(pil)
        if out.ndim == 2:
            out = out[:, :, None]
        return out

    def _random_crop(self, arr: np.ndarray, rng) -> np.ndarray:
        p = self.pad
        h, w = arr.shape[:2]
        mode = "reflect" if self.pad_mode == "reflect" else "constant"
        arr = np.pad(arr, ((p, p), (p, p), (0, 0)), mode=mode)
        i = rng.integers(0, 2 * p + 1)
        j = rng.integers(0, 2 * p + 1)
        return arr[i:i + h, j:j + w]

    def normalize(self, batch: np.ndarray) -> np.ndarray:
        return normalize_batch(batch, self.mean, self.std)


def normalize_batch(batch: np.ndarray, mean, std) -> np.ndarray:
    """uint8 NHWC -> float32 normalized NHWC (ToTensor + Normalize)."""
    x = batch.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


class Lighting:
    """AlexNet-style PCA lighting noise on normalized HWC float images."""

    def __init__(self, alphastd: float, eigval, eigvec):
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, img: np.ndarray, rng: np.random.Generator):
        if self.alphastd == 0:
            return img
        alpha = rng.normal(0, self.alphastd, 3).astype(np.float32)
        rgb = (self.eigvec * alpha[None, :] * self.eigval[None, :]).sum(1)
        return img + rgb[None, None, :]


def cutout_default(img: np.ndarray, length: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Zero-filled square cutout on normalized HWC float images."""
    h, w = img.shape[:2]
    y, x = rng.integers(h), rng.integers(w)
    y1, y2 = np.clip(y - length // 2, 0, h), np.clip(y + length // 2, 0, h)
    x1, x2 = np.clip(x - length // 2, 0, w), np.clip(x + length // 2, 0, w)
    out = img.copy()
    out[y1:y2, x1:x2] = 0.0
    return out
