"""Feature-embedding visualization (UMAP / t-SNE) and a linear probe.

Twin of ``graphlearninglayer_tpu/evalx/visualize.py``: 2-D embeddings of
encoder/head features with base points starred, plus an optional SGD
linear-probe accuracy.  UMAP is used when installed, else sklearn t-SNE (and
PCA as a last resort).  This is host-side post-processing: umap, sklearn and
matplotlib are imported when a function runs, never when the module is
imported, and a driver that calls :func:`visualize` treats a missing
package as "visualization skipped".

The JAX package's standalone checkpoint-visualization CLI (``main``) is not
ported.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["embed_2d", "plot_embedding", "linear_probe_accuracy",
           "visualize"]


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
