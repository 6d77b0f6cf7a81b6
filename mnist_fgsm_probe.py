"""The mnist config's 11,000-node FGSM point, with the op's edge distances
taken from the differences (as the port does) and from the KNN search's
|x|^2 + |y|^2 - 2 x.y (as the JAX package does), on one CUDA card.

    python3 mnist_fgsm_probe.py [--seeds 1 2 3 4] [--epochs 1 3] [--repeats 1]

For each seed and epoch count (``--repeats`` times: cuDNN's algorithms are
not deterministic, so each repeat trains other weights) it trains the mnist
config's SmallCNNGL naturally (``adversarial_driver.run``, 12,000 + 1,000
synthetic MNIST-geometry images, as ``chip_smoke.py``'s ``adversarial``
phase does), then
runs one FGSM point at eps 0.1 (``attack.driver.run``: 10,000 base + 1,000
test images, edge mode, Cholesky at tau 0) twice on that checkpoint: once
as the package stands, once with the op's graph built from the search's
distances.  It prints one JSON line a run: each side's largest Cholesky
info and accuracy, and, on the clean features of the point's first op
call, how many of the float32 search distances of non-self edges are 0 and
how many unlabeled nodes keep no edge on either side.  The card's
nvidia-smi name and power limit come on a line of their own.  It records;
it checks nothing, and exits non-zero only when no card is available.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from unittest import mock

from chip_smoke import ADV_MNIST_TEST, ADV_MNIST_TRAIN, K, card_line


def _search_graph(x, k, epsilon="auto", **_):
    """The graph of the JAX package's ``build_graph``: the search's d2."""
    from graphlearninglayer_tpu_torch.ops.graph import graph_from_knn
    from graphlearninglayer_tpu_torch.ops.knn import knn

    nbr, dist2 = knn(x, k)
    return graph_from_knn(nbr, dist2, epsilon, dtype=x.dtype)


def _clean_graph_counts(models: str, synth: dict, seed: int) -> dict:
    """Zero search distances and edgeless unlabeled nodes of the point's
    clean graph (10,000 base + 1,000 test features), on both sides."""
    import numpy as np
    import torch

    from graphlearninglayer_tpu_torch.attack import driver as attack_driver
    from graphlearninglayer_tpu_torch.data import (Transform, load_dataset,
                                                   select_base_indices)
    from graphlearninglayer_tpu_torch.ops import (build_graph, edge_weights,
                                                  sym_rowsum)
    from graphlearninglayer_tpu_torch.train import adversarial_driver as ad
    from graphlearninglayer_tpu_torch.train import create_train_state
    from graphlearninglayer_tpu_torch.utils.checkpoint import \
        restore_checkpoint

    cfg = ad.DATASET_CONFIGS["mnist"]
    dev = torch.device("cuda")
    spec = load_dataset("mnist", allow_synthetic_fallback=True, **synth)
    tf = Transform("mnist", "eval")
    state = create_train_state(
        ad.build_network("smallcnn_gl", 10, 1,
                         torch.Generator().manual_seed(seed)),
        ad._make_schedule(cfg, 1), device=dev, **ad._make_tx(cfg, "gl"))
    state, _ = restore_checkpoint(os.path.join(models, "mnist_gl_natural"),
                                  state)
    n_base = 10 * attack_driver.FGSM_BASE_RATE["mnist"]
    base_idx = select_base_indices(spec.train_labels, n_base, 10, "random",
                                   rng=np.random.default_rng(seed))
    x = torch.cat([ad._nchw(tf.normalize(spec.train_images[base_idx]), dev),
                   ad._nchw(tf.normalize(spec.test_images[:cfg.batch_size]),
                            dev)])
    with torch.no_grad():
        feats = ad._eval_features(state.model, x)
    out = {}
    for name, g in (("edge_d2", build_graph(feats, K)),
                    ("search_d2", _search_graph(feats, K))):
        off_self = g.nbr != torch.arange(len(x), device=dev)[:, None]
        deg = sym_rowsum(g, edge_weights(g)[0])[n_base:]
        out[name] = dict(zero_d2_edges=int((g.dist2[off_self] <= 0).sum()),
                         unlabeled_without_edges=int((deg == 0).sum()))
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    parser.add_argument("--epochs", type=int, nargs="+", default=[1, 3])
    parser.add_argument("--repeats", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from graphlearninglayer_tpu_torch.attack import driver as attack_driver
    from graphlearninglayer_tpu_torch.ops import laplace
    from graphlearninglayer_tpu_torch.train import adversarial_driver as ad

    synth = dict(n_train=ADV_MNIST_TRAIN, n_test=ADV_MNIST_TEST)
    runs = [(seed, epochs, rep) for seed in args.seeds
            for epochs in args.epochs for rep in range(args.repeats)]
    for seed, epochs, rep in runs:
        with tempfile.TemporaryDirectory(prefix="gll_probe_") as models:
            ad.run("gl", "natural", "mnist", epochs=epochs,
                   save_dir=models, seed=seed, synth=synth)
            line = dict(seed=seed, epochs=epochs, repeat=rep)
            for name, patch in (("edge_d2", None),
                                ("search_d2", _search_graph)):
                with mock.patch.object(laplace, "build_graph",
                                       patch or laplace.build_graph):
                    point = attack_driver.run(
                        "fgsm", "gl", "natural", "mnist",
                        ckpt_dir=models, sweep=[0.1], seed=seed,
                        save_images=False, synth=synth)["gl"][0]
                line[name] = dict(chol_info=point["chol_info"],
                                  accuracy=point["accuracy"])
            for name, counts in _clean_graph_counts(
                    models, synth, seed).items():
                line[name].update(counts)
            print(json.dumps(line), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
