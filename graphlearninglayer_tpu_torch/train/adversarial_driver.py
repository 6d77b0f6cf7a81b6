"""Natural / PGD-robust training driver for GL and MLP classifiers.

Twin of ``graphlearninglayer_tpu/train/adversarial_driver.py`` (the
reference's ``train_and_adversarial.py``, positional CLI ``{gl|mlp|both}
{natural|robust} {mnist|fashionmnist|cifar10|synthetic} [epochs]
[key=value ...]``):

  * a per-dataset config (network, batch size, base-sample rate,
    optimizer, LR schedule, normalized-range clamps, PGD epsilon);
  * natural training: MLP = NLL on the log-softmax outputs, GL = the graph
    head over base + batch features with the custom CE;
  * robust training: a 5-iteration PGD inner loop (uniform start, epsilon-
    ball and data-range clamps) before each step; for GL each iteration is
    a full op call, so a robust GL step runs the op 6 times;
  * a per-epoch eval, and a checkpoint in the port's format
    (``utils/checkpoint.py``) at ``{save_dir}/{dataset}_{target}_{rob_or_nat}``.

The dataset sits on the device as normalized NCHW float32; batches are row
gathers.  That layout stops at the model: PGD's iterates come out of
elementwise steps in NCHW strides whatever they were given, and on CUDA
a ``BuildNet`` (the fashionmnist networks) hands each of its encoder calls
to cuDNN in NHWC strides (``models/buildnet.py::nhwc_input``).  Losses,
the Cholesky infos and the op's gradient norms are read on the host once
an epoch.  One ``torch.Generator`` on the device, seeded from ``seed``,
draws the PGD starts and the dropout masks (a fresh mask each step; the
JAX driver reuses one dropout key for every step, ROADMAP section 3).
The GL steps report ``chol_info`` (0 when every Cholesky of the run,
PGD's included, succeeded): the op has no fallback solver.

Run on the card (the default) or, with ``--dev cpu``, on the CPU:
    python -m graphlearninglayer_tpu_torch.train.adversarial_driver \\
        gl robust synthetic 1 n_train=512 n_test=128 --dev cpu
"""
from __future__ import annotations

import math
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..attack.fgsm import check_grad_norms, max_chol_info, nll
from ..attack.pgd import make_gl_pgd_perturb_p, make_mlp_pgd_perturb_p
from ..data import Transform, load_dataset, select_base_indices
from ..data.datasets import parse_synth_overrides
from ..models import (BuildNet, Dropout, PreActResNetFeat, SmallCNN,
                      SmallCNNGL)
from ..ops import laplace_learning
from ..utils.checkpoint import save_checkpoint
from ..utils.meters import drain_correct
from ..utils.profiling import annotate, host_sync
from .losses import custom_ce_loss
from .trainer import _zero_grads, create_train_state, resolve_device

__all__ = ["AdvConfig", "DATASET_CONFIGS", "build_network",
           "make_train_step", "run", "main"]


@dataclass
class AdvConfig:
    dataset: str
    network_gl: str
    network_mlp: str
    min_val: float | np.ndarray
    max_val: float | np.ndarray
    pgd_epsilon: float
    batch_size: int
    base_sample_rate: int  # base samples per class
    lr: float
    epochs: int
    adam: bool = False
    lr_gamma: float = 1.0
    lr_step: int = 10 ** 9
    pgd_alpha: float = 0.01
    pgd_iters: int = 5
    # the op's tau: the reference drivers use 0.  The synthetic smoke
    # config uses a tiny tau so that collapsed-feature batches (coincident
    # points, zero-degree nodes) stay solvable.
    gl_tau: float = 0.0


# the reference's values; per-channel clamps are NCHW (1, 3, 1, 1), where
# the JAX package's NHWC ones are (1, 1, 1, 3)
DATASET_CONFIGS = {
    "mnist": AdvConfig("mnist", "smallcnn_gl", "smallcnn", -0.425, 2.822,
                       0.3, 1000, 10, 0.01, 100, adam=True, lr_gamma=0.1,
                       lr_step=25),
    "fashionmnist": AdvConfig("fashionmnist", "resnet18", "resnet18",
                              -0.8102, 2.0227, 0.05, 2000, 20, 0.01, 100,
                              adam=True, lr_gamma=0.5, lr_step=10),
    "cifar10": AdvConfig("cifar10", "preactresnet18", "preactresnet18",
                         np.array([-1.9895, -1.9803, -1.7068],
                                  np.float32).reshape(1, 3, 1, 1),
                         np.array([2.0591, 2.1265, 2.1158],
                                  np.float32).reshape(1, 3, 1, 1),
                         0.05, 200, 10, 0.1, 150),
    # offline-friendly small config for smoke runs
    "synthetic": AdvConfig("synthetic", "smallcnn_gl", "smallcnn", -1.0, 1.0,
                           0.1, 256, 8, 0.01, 3, adam=True, gl_tau=1e-6),
}


def build_network(name: str, num_classes: int = 10, in_channel: int = 1,
                  generator: torch.Generator | None = None):
    """The network ``name``, its initial weights drawn from ``generator``.
    Tuple-output networks return (log-probs or probs, features)."""
    if name == "smallcnn_gl":
        return SmallCNNGL(in_channel=in_channel, generator=generator)
    if name == "smallcnn":
        return SmallCNN(num_classes, in_channel=in_channel,
                        generator=generator)
    if name == "resnet18":
        # fashion-MNIST: buildnet(resnet18, head=linear, softmax) for both
        # heads
        return BuildNet("resnet18", head="linear", feat_dim=128,
                        num_classes=num_classes, softmax=True,
                        generator=generator, in_channel=in_channel)
    if name == "preactresnet18":
        return PreActResNetFeat(num_classes=num_classes,
                                in_channel=in_channel, generator=generator)
    raise ValueError(name)


def _features(out):
    return out[1] if isinstance(out, tuple) else out


def _logp(out):
    return out[0] if isinstance(out, tuple) else out


def _make_schedule(cfg: AdvConfig, steps_per_epoch: int):
    """Step-indexed LR (step 0 is the first update)."""
    if cfg.dataset == "cifar10":
        # optax.cosine_decay_schedule over 150 epochs: the reference's
        # CosineAnnealingLR(T_max=150), here per step
        total = 150 * steps_per_epoch
        return lambda step: cfg.lr * 0.5 * (
            1.0 + math.cos(math.pi * min(step, total) / total))
    if cfg.lr_step < 10 ** 8:
        # optax.exponential_decay(staircase=True)
        every = cfg.lr_step * steps_per_epoch
        return lambda step: cfg.lr * cfg.lr_gamma ** (step // every)
    return lambda step: cfg.lr


def _make_tx(cfg: AdvConfig, target: str) -> dict:
    """Per-dataset and target optimizer, as ``create_train_state``
    keywords: mnist GL Adam / MLP SGD (momentum 0.9, wd 5e-4);
    fashionmnist Adam for both; cifar10 SGD (momentum 0.9, wd 5e-4) for
    both.  Adam has no weight decay."""
    if cfg.dataset == "cifar10" or (cfg.dataset == "mnist"
                                    and target == "mlp"):
        return dict(adam=False, momentum=0.9, weight_decay=5e-4)
    if cfg.adam:
        return dict(adam=True, weight_decay=0.0)
    return dict(adam=False, momentum=0.9, weight_decay=0.0)


def _nchw(images: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Normalized NHWC float32 numpy images as NCHW on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(
        images.transpose(0, 3, 1, 2))).to(dev)


def _eval_features(model, x):
    model.eval()
    return _features(model(x))


def _eval_logp(model, x):
    model.eval()
    return _logp(model(x))


def _gl_train_step(state, num_classes: int, op_kw: dict, base_x, base_y,
                   x, y):
    """One GL step: the graph head over the base + batch features in train
    mode, the custom CE, one update.  Returns (loss, op stats).  The spans
    of ``trainer.py``'s GL step."""
    model = state.model
    model.train()
    stats: dict = {}
    with annotate("gl.encode"):
        feats = _features(model(torch.cat([base_x, x])))
    onehot = F.one_hot(base_y, num_classes).to(feats.dtype)
    pred = laplace_learning(feats, onehot, stats=stats, **op_kw)
    loss = custom_ce_loss(pred, y)
    with annotate("gl.update"):
        _zero_grads(model)
        with annotate("gl.backward"):
            loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
    return loss.detach(), stats


def _mlp_train_step(state, x, y):
    model = state.model
    model.train()
    loss = nll(_logp(model(x)), y)
    _zero_grads(model)
    loss.backward()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return loss.detach()


def make_train_step(target: str, rob_or_nat: str, cfg: AdvConfig,
                    num_classes: int, base_x, base_y, generator, min_val,
                    max_val, device):
    """One training step of ``target`` ('gl' or 'mlp'), the PGD inner loop
    first when ``rob_or_nat`` is 'robust', as ``step(state, x, y, stats)
    -> loss``.  A GL step appends each op call's ``stats`` dict (PGD's
    and the update's) to ``stats``; nothing waits for the device."""
    pgd = dict(eps=cfg.pgd_epsilon, alpha=cfg.pgd_alpha,
               num_iters=cfg.pgd_iters, device=device)
    op_kw = dict(tau=cfg.gl_tau, epsilon="auto", k=25)
    robust = rob_or_nat == "robust"
    if target == "gl":
        perturb = make_gl_pgd_perturb_p(_eval_features, num_classes,
                                        tau=cfg.gl_tau, k=25, **pgd)

        def step(state, x, y, stats):
            if robust:
                x = perturb(state.model, base_x, base_y, x, y, generator,
                            min_val, max_val, stats)
            loss, op_stats = _gl_train_step(state, num_classes, op_kw,
                                            base_x, base_y, x, y)
            stats.append(op_stats)
            return loss
    else:
        perturb = make_mlp_pgd_perturb_p(_eval_logp, **pgd)

        def step(state, x, y, stats):
            if robust:
                x = perturb(state.model, x, y, generator, min_val, max_val)
            return _mlp_train_step(state, x, y)
    return step


def run(model_type: str, rob_or_nat: str, dataset: str,
        epochs: int | None = None, save_dir: str = "models", seed: int = 1,
        synth: dict | None = None, device="cuda") -> dict:
    """Train and evaluate; returns ``{target}_acc`` (the last epoch's test
    accuracy) for each target, and per target its per-epoch ``_loss`` and
    ``_epoch_s``, ``_steps_per_epoch``, ``_eval_s`` and, for GL,
    ``_chol_info`` (the largest Cholesky info of the run)."""
    dev = resolve_device(device)
    cfg = DATASET_CONFIGS[dataset]
    if epochs is not None:
        cfg = AdvConfig(**{**cfg.__dict__, "epochs": epochs})
    spec = load_dataset("fashion_mnist" if dataset == "fashionmnist"
                        else dataset, allow_synthetic_fallback=True,
                        **(synth or {}))
    tf_name = ("fashion_mnist" if dataset == "fashionmnist" else
               dataset if dataset in ("mnist", "cifar10") else "synthetic")
    tf = Transform(tf_name, "eval")
    num_classes = spec.num_classes
    rng_np = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    min_val = torch.as_tensor(cfg.min_val, dtype=torch.float32, device=dev)
    max_val = torch.as_tensor(cfg.max_val, dtype=torch.float32, device=dev)
    op_kw = dict(tau=cfg.gl_tau, epsilon="auto", k=25)

    # the dataset on the device, once; batches are row gathers
    train_x = _nchw(tf.normalize(spec.train_images), dev)
    train_y = torch.as_tensor(spec.train_labels).long().to(dev)
    test_x = _nchw(tf.normalize(spec.test_images), dev)
    n_train = len(spec.train_labels)

    results: dict = {}
    targets = ["gl", "mlp"] if model_type == "both" else [model_type]
    for target in targets:
        is_gl = target == "gl"
        name = f"[{target}/{rob_or_nat}/{dataset}]"
        model = build_network(cfg.network_gl if is_gl else cfg.network_mlp,
                              num_classes, spec.image_shape[-1],
                              torch.Generator().manual_seed(seed))
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = gen
        steps_per_epoch = max(n_train // cfg.batch_size, 1)
        state = create_train_state(model, _make_schedule(cfg,
                                                         steps_per_epoch),
                                   device=dev, **_make_tx(cfg, target))
        base_idx = torch.as_tensor(select_base_indices(
            spec.train_labels, cfg.base_sample_rate * num_classes,
            num_classes, "random", rng=rng_np)).to(dev)
        base_x, base_y = train_x[base_idx], train_y[base_idx]
        step = make_train_step(target, rob_or_nat, cfg, num_classes, base_x,
                               base_y, gen, min_val, max_val, dev)

        print(f"{name} training ({steps_per_epoch} steps/epoch)...",
              flush=True)
        rec = {"loss": [], "epoch_s": [], "eval_s": []}
        chol_info = 0
        for epoch in range(1, cfg.epochs + 1):
            t0 = time.perf_counter()
            order = torch.as_tensor(rng_np.permutation(n_train)).to(dev)
            losses, stats = [], []
            for i in range(steps_per_epoch):
                sel = order[i * cfg.batch_size:(i + 1) * cfg.batch_size]
                losses.append(step(state, train_x[sel], train_y[sel], stats))
            # the epoch's losses, Cholesky infos and norms, read once
            host_sync("adversarial.epoch_loss")
            mean_loss = torch.stack(losses).mean().item()
            chol_info = max(chol_info, max_chol_info(stats))
            check_grad_norms(stats)
            rec["loss"].append(mean_loss)
            rec["epoch_s"].append(time.perf_counter() - t0)
            print(f"{name} epoch {epoch} avg loss {mean_loss:.4f} "
                  f"({rec['epoch_s'][-1]:.1f}s)")
            if chol_info:
                print(f"{name} WARNING: a Cholesky factorization failed "
                      f"(info {chol_info})")

            # the eval batch is capped at the test-set size: a test split
            # smaller than the training batch would otherwise leave no
            # full batch
            t1 = time.perf_counter()
            eval_bs = min(cfg.batch_size, len(spec.test_labels))
            usable = (len(spec.test_labels) // eval_bs) * eval_bs
            preds = []
            with torch.no_grad():
                for j in range(0, usable, eval_bs):
                    xb = test_x[j:j + eval_bs]
                    if is_gl:
                        feats = _eval_features(state.model,
                                               torch.cat([base_x, xb]))
                        onehot = F.one_hot(base_y, num_classes).to(
                            feats.dtype)
                        out = laplace_learning(feats, onehot, **op_kw)
                    else:
                        out = _eval_logp(state.model, xb)
                    preds.append(torch.argmax(out, dim=1))
            acc = drain_correct(preds, spec.test_labels[:usable]) / max(
                usable, 1)
            rec["eval_s"].append(time.perf_counter() - t1)
            print(f"  test acc: {acc:.4f}")
            results[f"{target}_acc"] = acc

        results.update({f"{target}_{k}": v for k, v in rec.items()})
        results[f"{target}_steps_per_epoch"] = steps_per_epoch
        if is_gl:
            results[f"{target}_chol_info"] = chol_info
        save_checkpoint(os.path.join(
            save_dir, f"{dataset}_{target}_{rob_or_nat}"), state, cfg.epochs)
    return results


def _pop_dev(argv: list) -> tuple[list, str]:
    """Remove ``--dev X`` from ``argv``; returns (rest, X or 'cuda')."""
    if "--dev" not in argv:
        return argv, "cuda"
    i = argv.index("--dev")
    if i + 1 >= len(argv):
        raise SystemExit("--dev needs a value: cuda or cpu")
    return argv[:i] + argv[i + 2:], argv[i + 1]


def _require_cli_device(dev: str) -> None:
    """A CLI's device check: the card unless ``--dev cpu``."""
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --dev cpu to run on "
                           "the CPU")


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    argv, dev = _pop_dev(argv)
    # trailing key=value tokens are synthetic-generator overrides
    # (e.g. synth_sep=1.0 n_train=20000) for hardened-proxy runs
    synth = parse_synth_overrides([a for a in argv if "=" in a])
    argv = [a for a in argv if "=" not in a]
    if len(argv) < 3:
        raise SystemExit("usage: adversarial_driver {gl|mlp|both} "
                         "{natural|robust} {mnist|fashionmnist|cifar10|synthetic}"
                         " [epochs] [synth_sep=F n_train=N ...] [--dev cpu]")
    model_type, rob_or_nat, dataset = argv[0], argv[1], argv[2]
    if model_type not in ("gl", "mlp", "both"):
        raise ValueError("argument must be gl, mlp, or both")
    if rob_or_nat not in ("natural", "robust"):
        raise ValueError("argument must be natural or robust")
    epochs = int(argv[3]) if len(argv) > 3 else None
    _require_cli_device(dev)
    print("Classifier:", model_type)
    return run(model_type, rob_or_nat, dataset, epochs=epochs, synth=synth,
               device=dev)


if __name__ == "__main__":
    main()
