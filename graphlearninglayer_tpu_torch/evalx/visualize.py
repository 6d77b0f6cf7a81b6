"""Feature-embedding visualization (UMAP / t-SNE) and a linear probe.

Twin of ``graphlearninglayer_tpu/evalx/visualize.py``: 2-D embeddings of
encoder/head features with base points starred, plus an optional SGD
linear-probe accuracy.  UMAP is used when installed, else sklearn t-SNE (and
PCA as a last resort).  This is host-side post-processing: umap, sklearn and
matplotlib are imported when a function runs, never when the module is
imported, and a driver that calls :func:`visualize` treats a missing
package as "visualization skipped".

``main`` is the standalone CLI: it restores a checkpoint of this package
(``utils/checkpoint.py``), encodes up to ``--max_points`` train and test
images on the card (or, with ``--dev cpu``, on the CPU), writes the
embedding PNG pair per split and, with ``--probe``, prints a linear-probe
accuracy; the plots and the probe print "skipped" where matplotlib or
sklearn is missing:

    python -m graphlearninglayer_tpu_torch.evalx.visualize CKPT \
        --dataset cifar10 [--probe] [--dev cpu]
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["embed_2d", "plot_embedding", "linear_probe_accuracy",
           "visualize", "main"]


def embed_2d(features: np.ndarray, method: str = "auto",
             seed: int = 0) -> np.ndarray:
    """2-D embedding via UMAP -> t-SNE -> PCA fallback chain."""
    if method in ("auto", "umap"):
        try:
            import umap

            return umap.UMAP(random_state=seed).fit_transform(features)
        except ImportError:
            if method == "umap":
                raise
    if method in ("auto", "tsne"):
        from sklearn.manifold import TSNE

        return TSNE(n_components=2, random_state=seed,
                    init="pca").fit_transform(features)
    from sklearn.decomposition import PCA

    return PCA(n_components=2, random_state=seed).fit_transform(features)


def plot_embedding(emb: np.ndarray, labels: np.ndarray, path: str,
                   base_mask: np.ndarray | None = None, title: str = ""):
    """Scatter by class with base points starred ."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(8, 8))
    scatter = plt.scatter(emb[:, 0], emb[:, 1], c=labels, s=3, cmap="tab10",
                          alpha=0.6)
    if base_mask is not None and base_mask.any():
        plt.scatter(emb[base_mask, 0], emb[base_mask, 1], c="black",
                    marker="*", s=60, label="base")
        plt.legend()
    plt.colorbar(scatter)
    plt.title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, dpi=120)
    plt.close()


def linear_probe_accuracy(train_feats, train_labels, test_feats,
                          test_labels, seed: int = 0) -> float:
    """SGD linear-probe accuracy on frozen features."""
    from sklearn.linear_model import SGDClassifier

    clf = SGDClassifier(loss="log_loss", random_state=seed, max_iter=20)
    clf.fit(train_feats, train_labels)
    return float(clf.score(test_feats, test_labels))


def visualize(features: np.ndarray, labels: np.ndarray, save_dir: str,
              base_mask: np.ndarray | None = None, tsne: bool = False,
              seed: int = 0, prefix: str = "features"):
    """Embed + plot; optionally also t-SNE (the --TSNE flag)."""
    emb = embed_2d(features, "auto", seed)
    plot_embedding(emb, labels, os.path.join(save_dir, f"{prefix}_umap.png"),
                   base_mask, f"{prefix} (auto embed)")
    if tsne:
        emb_t = embed_2d(features, "tsne", seed)
        plot_embedding(emb_t, labels,
                       os.path.join(save_dir, f"{prefix}_tsne.png"),
                       base_mask, f"{prefix} (t-SNE)")
    return emb


def main(argv=None) -> dict:
    """Standalone checkpoint visualization: restore a checkpoint, encode
    train and test features, write the embedding PNG pair per split,
    optionally report a linear-probe accuracy on the frozen features.
    Returns ``{split: (features (n, d) float32, labels)}``."""
    import argparse

    parser = argparse.ArgumentParser("visualize a saved checkpoint")
    parser.add_argument("ckpt", help="checkpoint directory or .pth file")
    parser.add_argument("--dataset", type=str, default="cifar10")
    parser.add_argument("--model", type=str, default="resnet18")
    parser.add_argument("--head", type=str, default="mlp",
                        choices=["linear", "mlp", "no"])
    parser.add_argument("--embedding_dim", type=int, default=128)
    parser.add_argument("--tsne", action="store_true",
                        help="also produce t-SNE plots")
    parser.add_argument("--probe", action="store_true",
                        help="SGD linear-probe accuracy on frozen features")
    parser.add_argument("--save_dir", type=str, default=None,
                        help="output dir (default: the checkpoint dir)")
    parser.add_argument("--max_points", type=int, default=10000,
                        help="cap on points embedded per split")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dev", type=str, default="cuda",
                        help="device: cuda (the default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from ..data import CHANNEL_STATS, Transform, load_dataset
    from ..models import BuildNet
    from ..train.optim import make_lr_schedule
    from ..train.trainer import (create_train_state, make_encode_step,
                                 resolve_device)
    from ..utils.checkpoint import restore_checkpoint
    from .harness import encode_dataset

    if args.dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --dev cpu to run on "
                           "the CPU")
    dev = resolve_device(args.dev)
    spec = load_dataset(args.dataset, allow_synthetic_fallback=True)
    tf = Transform(spec.name if spec.name in CHANNEL_STATS else "synthetic",
                   "eval")
    model = BuildNet(name=args.model, head=args.head,
                     feat_dim=args.embedding_dim,
                     num_classes=spec.num_classes,
                     in_channel=spec.image_shape[-1])
    state = create_train_state(model, make_lr_schedule(0.1, 1, 1),
                               device=dev)
    state, epoch = restore_checkpoint(args.ckpt, state)
    print(f"restored checkpoint epoch {epoch} from {args.ckpt}")

    save_dir = args.save_dir or (args.ckpt if os.path.isdir(args.ckpt)
                                 else os.path.dirname(args.ckpt))
    encode_step = make_encode_step(norm=(tf.mean, tf.std), device=dev)
    rng = np.random.default_rng(args.seed)
    splits = {"train": (spec.train_images, spec.train_labels),
              "test": (spec.test_images, spec.test_labels)}
    feats = {}
    for name, (images, labels) in splits.items():
        if len(images) > args.max_points:
            sel = rng.permutation(len(images))[:args.max_points]
            images, labels = images[sel], labels[sel]
        f = encode_dataset(encode_step, state, images).float().cpu().numpy()
        feats[name] = (f, labels)
        prefix = f"{args.dataset}_{name}"
        print(f"{name}: encoded {len(f)} points")
        try:
            visualize(f, labels, save_dir, tsne=args.tsne, seed=args.seed,
                      prefix=prefix)
            print(f"{name}: embedded -> {save_dir}/{prefix}_umap.png")
        except ImportError as e:
            print(f"{name}: plots skipped ({e})")

    if args.probe:
        try:
            acc = linear_probe_accuracy(*feats["train"], *feats["test"],
                                        seed=args.seed)
            print(f"Linear Classifier Accuracy is {100 * acc:.2f}%")
        except ImportError as e:
            print(f"linear probe skipped ({e})")
    return feats


if __name__ == "__main__":
    main()
