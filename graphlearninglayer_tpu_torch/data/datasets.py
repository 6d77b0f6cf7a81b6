"""Dataset registry, raw-format loaders and synthetic datasets.

Twin of ``graphlearninglayer_tpu/data/datasets.py`` (and the keeper of
``CHANNEL_STATS``, which the JAX package holds in ``data/augment.py``):
MNIST / FashionMNIST (IDX files), CIFAR-10 / CIFAR-100 (python-pickle
batches) and mini-ImageNet (an npz cache, the Ravi & Larochelle pickles or
an image-folder tree), searched in ``$GLL_DATA_DIR``, then ``data-local``,
``data`` and ``~/data``.  A deterministic ``synthetic`` dataset stands in
where no files are present; the same seed and arguments give byte-identical
images and labels to the JAX package's.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["CHANNEL_STATS", "DatasetSpec", "DATASETS", "load_dataset",
           "synthetic_dataset", "synth_kwargs_from_opt",
           "parse_synth_overrides"]

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


def _data_roots():
    roots = []
    if os.environ.get("GLL_DATA_DIR"):
        roots.append(os.environ["GLL_DATA_DIR"])
    roots += ["data-local", "data", os.path.expanduser("~/data")]
    return roots


def _find(relpaths):
    for root in _data_roots():
        for rel in relpaths:
            p = os.path.join(root, rel)
            if os.path.exists(p):
                return p
    return None


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        _, dtype_code, ndim = magic
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _load_mnist_family(name: str) -> DatasetSpec | None:
    files = {}
    for split, img, lbl in (("train", "train-images-idx3-ubyte",
                             "train-labels-idx1-ubyte"),
                            ("test", "t10k-images-idx3-ubyte",
                             "t10k-labels-idx1-ubyte")):
        img_p = _find([f"{name}/{img}", f"{name}/{img}.gz",
                       f"images/{name}/{img}", f"{name}/raw/{img}",
                       f"{name}/raw/{img}.gz"])
        lbl_p = _find([f"{name}/{lbl}", f"{name}/{lbl}.gz",
                       f"images/{name}/{lbl}", f"{name}/raw/{lbl}",
                       f"{name}/raw/{lbl}.gz"])
        if img_p is None or lbl_p is None:
            return None
        files[split] = (img_p, lbl_p)
    tri = _read_idx(files["train"][0])[..., None]
    trl = _read_idx(files["train"][1]).astype(np.int64)
    tei = _read_idx(files["test"][0])[..., None]
    tel = _read_idx(files["test"][1]).astype(np.int64)
    return DatasetSpec(name, tri, trl, tei, tel, 10)


def _load_cifar(name: str) -> DatasetSpec | None:
    if name == "cifar10":
        subdir, train_files, test_files, label_key, n_cls = (
            "cifar-10-batches-py",
            [f"data_batch_{i}" for i in range(1, 6)], ["test_batch"],
            b"labels", 10)
    else:
        subdir, train_files, test_files, label_key, n_cls = (
            "cifar-100-python", ["train"], ["test"], b"fine_labels", 100)

    def read(files):
        imgs, labels = [], []
        for fn in files:
            p = _find([f"{subdir}/{fn}", f"cifar/{subdir}/{fn}",
                       f"images/cifar/{subdir}/{fn}"])
            if p is None:
                return None, None
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            imgs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            labels.append(np.asarray(d[label_key], np.int64))
        return np.concatenate(imgs), np.concatenate(labels)

    tri, trl = read(train_files)
    if tri is None:
        return None
    tei, tel = read(test_files)
    if tei is None:
        return None
    return DatasetSpec(name, tri, trl, tei, tel, n_cls)


def _load_miniimagenet() -> DatasetSpec | None:
    """mini-ImageNet, 84x84x3, 100 classes.

    Three on-disk layouts are recognized, first hit wins:

    1. ``miniimagenet.npz`` with train_images/train_labels/test_images/
       test_labels arrays (uint8 NHWC / int labels) — the fast local cache.
    2. The Ravi & Larochelle pickle caches ``mini-imagenet-cache-
       {train,val,test}.pkl`` ({'image_data': (N,84,84,3) uint8,
       'class_dict': {name: [row indices]}}).  The episodic splits hold
       disjoint classes, so for the reference's 100-way classification use
       all three are pooled and each class is split deterministically
       (last 100 images per class -> test, rest -> train), the 500/100
       per-class convention of the mean-teacher preparation.
    3. An image-folder tree ``miniimagenet/{train,test|val}/<class>/*`` of
       PNG/JPEG files (the mean-teacher data-local layout itself).
    """
    npz = _find(["miniimagenet.npz", "miniimagenet/miniimagenet.npz",
                 "images/miniimagenet/miniimagenet.npz"])
    if npz is not None:
        with np.load(npz) as z:
            return DatasetSpec("miniimagenet",
                               z["train_images"],
                               z["train_labels"].astype(np.int64),
                               z["test_images"],
                               z["test_labels"].astype(np.int64), 100)

    caches = [_find([f"mini-imagenet-cache-{s}.pkl",
                     f"miniimagenet/mini-imagenet-cache-{s}.pkl",
                     f"images/miniimagenet/mini-imagenet-cache-{s}.pkl"])
              for s in ("train", "val", "test")]
    if all(p is not None for p in caches):
        images, labels, next_label = [], [], 0
        for p in caches:
            with open(p, "rb") as f:
                d = pickle.load(f)
            data = np.asarray(d["image_data"], np.uint8)
            for name in sorted(d["class_dict"]):
                idx = np.asarray(d["class_dict"][name], np.int64)
                images.append(data[idx])
                labels.append(np.full(len(idx), next_label, np.int64))
                next_label += 1
        images, labels = np.concatenate(images), np.concatenate(labels)
        tr_i, tr_l, te_i, te_l = [], [], [], []
        for c in range(next_label):
            rows = np.flatnonzero(labels == c)
            n_test = max(1, min(100, len(rows) // 6))
            tr_i.append(images[rows[:-n_test]])
            tr_l.append(labels[rows[:-n_test]])
            te_i.append(images[rows[-n_test:]])
            te_l.append(labels[rows[-n_test:]])
        return DatasetSpec("miniimagenet",
                           np.concatenate(tr_i), np.concatenate(tr_l),
                           np.concatenate(te_i), np.concatenate(te_l),
                           next_label)

    root = _find(["miniimagenet/train", "images/miniimagenet/train"])
    if root is not None:
        base = os.path.dirname(root)
        test_dir = next((os.path.join(base, s) for s in ("test", "val")
                         if os.path.isdir(os.path.join(base, s))), None)
        if test_dir is None:
            return None
        import PIL.Image

        # ONE class->index mapping over the union of both trees: indexing
        # each split independently silently misaligns labels whenever the
        # splits' class-directory sets differ (e.g. episodic layouts with
        # disjoint train/val classes)
        def class_dirs(d):
            return sorted(e for e in os.listdir(d)
                          if os.path.isdir(os.path.join(d, e)))

        classes = sorted(set(class_dirs(root)) | set(class_dirs(test_dir)))
        class_to_idx = {c: i for i, c in enumerate(classes)}
        img_exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

        def read_tree(d):
            imgs, labels = [], []
            for cname in class_dirs(d):
                cdir = os.path.join(d, cname)
                for fn in sorted(os.listdir(cdir)):
                    if not fn.lower().endswith(img_exts):
                        continue  # stray non-image files (.DS_Store, ...)
                    with PIL.Image.open(os.path.join(cdir, fn)) as im:
                        arr = np.asarray(im.convert("RGB"), np.uint8)
                    imgs.append(arr)
                    labels.append(class_to_idx[cname])
            return np.stack(imgs), np.asarray(labels, np.int64)

        tri, trl = read_tree(root)
        tei, tel = read_tree(test_dir)
        return DatasetSpec("miniimagenet", tri, trl, tei, tel, len(classes))
    return None


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


def synth_kwargs_from_opt(opt) -> dict:
    """Collect the synthetic-generator kwargs from a parsed CLI namespace
    (geometry + the difficulty knobs); shared by every driver so the hard
    generator is reachable from all of them."""
    kw = dict(n_train=getattr(opt, "synth_n_train", 4096),
              n_test=getattr(opt, "synth_n_test", 1024))
    sep = getattr(opt, "synth_sep", None)
    if sep is not None:
        kw.update(class_sep=sep,
                  modes_per_class=getattr(opt, "synth_modes", 3),
                  noise_std=getattr(opt, "synth_noise", 0.35))
    ln = getattr(opt, "synth_label_noise", 0.0)
    if ln:
        kw["label_noise"] = ln
    return kw


_SYNTH_KEYMAP = {
    "synth_sep": ("class_sep", float), "class_sep": ("class_sep", float),
    "synth_modes": ("modes_per_class", int),
    "modes_per_class": ("modes_per_class", int),
    "synth_label_noise": ("label_noise", float),
    "label_noise": ("label_noise", float),
    "synth_noise": ("noise_std", float), "noise_std": ("noise_std", float),
    "synth_n_train": ("n_train", int), "n_train": ("n_train", int),
    "synth_n_test": ("n_test", int), "n_test": ("n_test", int),
    "seed": ("seed", int), "latent_dim": ("latent_dim", int),
}


def parse_synth_overrides(tokens) -> dict:
    """Parse ``key=value`` tokens (positional-CLI drivers) into
    :func:`synthetic_dataset` kwargs; unknown keys raise."""
    kw = {}
    for tok in tokens:
        key, _, val = tok.partition("=")
        if key not in _SYNTH_KEYMAP:
            raise ValueError(f"unknown synthetic override {key!r} "
                             f"(known: {sorted(_SYNTH_KEYMAP)})")
        name, cast = _SYNTH_KEYMAP[key]
        kw[name] = cast(val)
    return kw


DATASETS = {
    "mnist": lambda: _load_mnist_family("mnist"),
    "fashion_mnist": lambda: _load_mnist_family("fashion_mnist"),
    "fashionmnist": lambda: _load_mnist_family("fashion_mnist"),
    "cifar10": lambda: _load_cifar("cifar10"),
    "cifar100": lambda: _load_cifar("cifar100"),
    "miniimagenet": _load_miniimagenet,
    "synthetic": synthetic_dataset,
}


def load_dataset(name: str, allow_synthetic_fallback: bool = False,
                 **synth_kwargs) -> DatasetSpec:
    """Load a dataset by name; optionally fall back to synthetic data with
    the same geometry when the files are absent (offline machines)."""
    if name == "synthetic":
        return synthetic_dataset(**synth_kwargs)
    loader = DATASETS.get(name)
    if loader is None:
        raise ValueError(f"unknown dataset {name!r}")
    spec = loader()
    if spec is not None:
        return spec
    if not allow_synthetic_fallback:
        raise FileNotFoundError(
            f"dataset {name!r} not found under $GLL_DATA_DIR / data-local; "
            "pass allow_synthetic_fallback=True for a synthetic stand-in")
    if name == "miniimagenet":
        shape, n_cls = (84, 84, 3), 100
    else:
        shape = (32, 32, 3) if name.startswith("cifar") else (28, 28, 1)
        n_cls = 100 if name == "cifar100" else 10
    spec = synthetic_dataset(n_cls, shape, **synth_kwargs)
    spec.name = name
    return spec
