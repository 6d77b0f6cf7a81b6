"""Attack evaluation driver: FGSM / IFGSM / CW sweeps.

Twin of ``graphlearninglayer_tpu/attack/driver.py`` (the reference's
``adversarial.py``, positional CLI ``{fgsm|ifgsm|cw} {gl|mlp|both}
{robust|natural} {dataset} [sweep points ...] [key=value ...]``): restores
the checkpoint that ``train/adversarial_driver.py`` wrote, sweeps epsilon in
{0, 0.05, ..., 1} for (I)FGSM or c in {1, 5, ..., 1000} for CW, reports the
accuracy of each point, and saves adversarial-example image grids where
matplotlib is installed.

Run on the card (the default) or, with ``--dev cpu``, on the CPU:
    python -m graphlearninglayer_tpu_torch.attack.driver \\
        fgsm gl natural synthetic 0 0.1 n_train=512 n_test=128 --dev cpu
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..data import Transform, load_dataset, select_base_indices
from ..data.datasets import parse_synth_overrides
from ..train.adversarial_driver import (DATASET_CONFIGS, _features, _logp,
                                        _make_schedule, _make_tx, _nchw,
                                        _pop_dev, _require_cli_device,
                                        build_network)
from ..train.trainer import create_train_state, resolve_device
from ..utils.checkpoint import restore_checkpoint
from ..utils.meters import drain_correct
from .cw import make_gl_cw_attack, make_mlp_cw_attack
from .fgsm import (check_grad_norms, make_gl_fast_gradient_attack,
                   make_mlp_fast_gradient_attack, max_chol_info)

__all__ = ["EPSILON_SWEEP", "C_SWEEP", "FGSM_BASE_RATE", "CW_BASE_RATE",
           "run", "main"]

EPSILON_SWEEP = [0.0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45,
                 0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95, 1.0]
C_SWEEP = [1, 5, 10, 20, 50, 100, 200, 500, 1000]

# base samples per class for the attack evals
FGSM_BASE_RATE = {"mnist": 1000, "fashionmnist": 50, "cifar10": 50,
                  "synthetic": 16}
CW_BASE_RATE = {"mnist": 100, "fashionmnist": 50, "cifar10": 50,
                "synthetic": 16}


def _save_example_grid(clean, adv, path):
    """Adversarial-example strip: clean / adversarial / difference, from
    NCHW arrays.  Prints "example grid skipped" where matplotlib is absent
    or the file cannot be written."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"example grid skipped: {e}")
        return
    n = min(8, len(clean))
    fig, axes = plt.subplots(3, n, figsize=(2 * n, 6))
    for i in range(n):
        for row, img in enumerate((clean[i], adv[i], adv[i] - clean[i])):
            ax = axes[row, i] if n > 1 else axes[row]
            im = img.transpose(1, 2, 0).squeeze()
            ax.imshow(im if im.ndim == 2 else
                      (im - im.min()) / (np.ptp(im) + 1e-9))
            ax.axis("off")
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        plt.savefig(path, dpi=100)
    except OSError as e:
        print(f"example grid skipped: {e}")
    finally:
        plt.close(fig)


def run(attack: str, model_type: str, rob_or_nat: str, dataset: str,
        ckpt_dir: str = "models", batch_size: int | None = None,
        sweep=None, cw_iters: int = 100, seed: int = 1,
        save_images: bool = True, synth: dict | None = None,
        device="cuda") -> dict:
    """Returns ``{target: [{"point", "accuracy", "s"}, ...]}``, ``s`` the
    host seconds of the sweep point, which ends in reading its
    predictions; for GL also ``chol_info`` (the largest Cholesky info of
    the point's op calls, 0 when all succeeded) and ``op_calls``."""
    if attack not in ("fgsm", "ifgsm", "cw"):
        raise ValueError("attack must be fgsm, ifgsm, or cw")
    dev = resolve_device(device)
    cfg = DATASET_CONFIGS[dataset]
    spec = load_dataset("fashion_mnist" if dataset == "fashionmnist"
                        else dataset, allow_synthetic_fallback=True,
                        **(synth or {}))
    tf_name = ("fashion_mnist" if dataset == "fashionmnist" else
               dataset if dataset in ("mnist", "cifar10") else "synthetic")
    tf = Transform(tf_name, "eval")
    num_classes = spec.num_classes
    rng_np = np.random.default_rng(seed)
    batch_size = batch_size or min(cfg.batch_size, 1000)
    min_val = torch.as_tensor(cfg.min_val, dtype=torch.float32, device=dev)
    max_val = torch.as_tensor(cfg.max_val, dtype=torch.float32, device=dev)
    fast = attack in ("fgsm", "ifgsm")

    # the test set on the device once; of the train set only the base rows
    # are shipped
    train_x = tf.normalize(spec.train_images)
    test_x = _nchw(tf.normalize(spec.test_images), dev)
    test_y = spec.test_labels
    test_y_dev = torch.as_tensor(test_y).long().to(dev)

    results = {}
    targets = ["gl", "mlp"] if model_type == "both" else [model_type]
    for target in targets:
        is_gl = target == "gl"
        model = build_network(cfg.network_gl if is_gl else cfg.network_mlp,
                              num_classes, spec.image_shape[-1],
                              torch.Generator().manual_seed(seed))
        state = create_train_state(model, _make_schedule(cfg, 1), device=dev,
                                   **_make_tx(cfg, target))
        ckpt = os.path.join(ckpt_dir, f"{dataset}_{target}_{rob_or_nat}")
        if os.path.isdir(ckpt):
            state, _ = restore_checkpoint(ckpt, state)
            print(f"loaded weights from {ckpt}")
        else:
            print(f"WARNING: no checkpoint at {ckpt}; attacking random init")
        net = state.model.eval()

        def encode(images):
            return _features(net(images))

        def classify(images):
            return _logp(net(images))

        rate = (FGSM_BASE_RATE if fast else CW_BASE_RATE)[dataset]
        base_idx = select_base_indices(spec.train_labels, rate * num_classes,
                                       num_classes, "random", rng=rng_np)
        base_x = _nchw(train_x[base_idx], dev)
        base_y = torch.as_tensor(spec.train_labels[base_idx]).long().to(dev)

        points = sweep if sweep is not None else (
            EPSILON_SWEEP if fast else C_SWEEP)
        usable = (len(test_y) // batch_size) * batch_size
        if fast:
            atk = (make_gl_fast_gradient_attack(encode, num_classes, tau=0.0,
                                                k=25, device=dev)
                   if is_gl else make_mlp_fast_gradient_attack(classify,
                                                               device=dev))
        else:
            atk = (make_gl_cw_attack(encode, num_classes, tau=0.0, k=25,
                                     iters=cw_iters, device=dev)
                   if is_gl else make_mlp_cw_attack(classify, iters=cw_iters,
                                                    device=dev))
        curve = []
        for point in points:
            t0 = time.perf_counter()
            first_batch = None
            preds, stats = [], []
            for i in range(0, usable, batch_size):
                x = test_x[i:i + batch_size]
                if fast:
                    y = test_y_dev[i:i + batch_size]
                    adv, pred = (atk(base_x, base_y, x, y, float(point),
                                     attack, min_val, max_val, stats)
                                 if is_gl else
                                 atk(x, y, float(point), attack, min_val,
                                     max_val))
                else:
                    adv, _, pred = (atk(base_x, base_y, x, float(point),
                                        min_val, max_val, stats) if is_gl
                                    else atk(x, float(point), min_val,
                                             max_val))
                preds.append(pred)
                if first_batch is None:
                    first_batch = (x, adv)
            correct = drain_correct(preds, test_y[:usable])
            seconds = time.perf_counter() - t0
            acc = correct / max(usable, 1)
            label = "Epsilon" if fast else "c"
            print(f"{label}: {point}\tTest Accuracy = {correct} / {usable}"
                  f" = {acc:.4f}")
            entry = {"point": float(point), "accuracy": acc, "s": seconds}
            if is_gl:
                check_grad_norms(stats)
                entry["chol_info"] = max_chol_info(stats)
                entry["op_calls"] = len(stats)
            curve.append(entry)
            if save_images and first_batch is not None:
                _save_example_grid(
                    first_batch[0].cpu().numpy(),
                    first_batch[1].detach().cpu().numpy(),
                    os.path.join("images",
                                 f"{dataset}_{target}_{attack}_{point}.png"))
        results[target] = curve
    return results


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    argv, dev = _pop_dev(argv)
    # trailing key=value tokens select the synthetic generator; they must
    # match the adversarial_driver run that trained the checkpoint
    synth = parse_synth_overrides([a for a in argv if "=" in a])
    argv = [a for a in argv if "=" not in a]
    if len(argv) < 4:
        raise SystemExit("usage: driver {fgsm|ifgsm|cw} {gl|mlp|both} "
                         "{robust|natural} {dataset} [sweep points...] "
                         "[synth_sep=F n_train=N ...] [--dev cpu]")
    attack, model_type, rob_or_nat, dataset = argv[:4]
    if attack not in ("fgsm", "ifgsm", "cw"):
        raise ValueError("attack must be fgsm, ifgsm, or cw")
    sweep = [float(p) for p in argv[4:]] or None
    _require_cli_device(dev)
    results = run(attack, model_type, rob_or_nat, dataset, sweep=sweep,
                  synth=synth, device=dev)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
