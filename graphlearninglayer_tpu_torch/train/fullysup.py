"""Fully-supervised training driver (GL or MLP head).

Twin of ``graphlearninglayer_tpu/train/fullysup.py`` on one device:
loaders -> model -> optional MLP-head pretrain -> epoch loop (GL or MLP
branch) with per-step score updates, periodic base-set refresh
(random/score), transductive + per-batch eval, checkpoints, loss/accuracy
record plots and a stdout tee.  Each step runs on the device without a host
sync; the host loop moves data and reads the metrics in one stacked copy at
each print boundary.

Run on the card (the default) or, with ``--dev cpu``, on the CPU:

    python -m graphlearninglayer_tpu_torch.train.fullysup \\
        --sup_train_type gl --dataset cifar10 --cosine [--epsilon auto ...]

Not ported yet (they raise ``NotImplementedError``, ROADMAP.md slice 6):
``--device_data``, ``--mesh N`` with N > 1 (``auto`` with one visible
device runs as ``off``) and multi-process runs.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..config.cli import parse_option
from ..data import (BatchLoader, ScoredDataset, Transform, load_dataset,
                    synth_kwargs_from_opt)
from ..data.pipeline import downsample_by_stride
from ..evalx import encode_dataset, test_gl_transductive, test_network
from ..models import BuildNet
from ..ops import EvalGraphCache, warn_exploding_grad
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.meters import AverageMeter, FileLogger, Throughput
from ..utils.profiling import trace_steps
from .losses import custom_ce_loss
from .optim import make_lr_schedule
from .trainer import (_device_normalize, create_train_state,
                      make_encode_step, make_gl_train_step,
                      make_mlp_train_step, resolve_device)

__all__ = ["main", "run_training", "pretrain_linear"]

_NOT_PORTED = "is not ported yet (ROADMAP.md, section 1, slice 6)"


def pretrain_linear(state, loader, opt, norm=None):
    """MLP-classifier-head pretraining with the rest of the network frozen
    and BatchNorm in inference mode.  Updates only the ``linear``
    aux-classifier parameters, with SGD (momentum, no weight decay) at
    lr * pretrain_lr_multiply, for ``opt.sup_epochs`` epochs."""
    if opt.sup_epochs <= 0:
        return state
    model = state.model
    head = list(model.linear.parameters())
    head_ids = {id(p) for p in head}
    frozen = [p for p in model.parameters()
              if id(p) not in head_ids and p.requires_grad]
    sgd = torch.optim.SGD(head, lr=opt.learning_rate
                          * opt.pretrain_lr_multiply, momentum=opt.momentum)
    model.eval()
    for p in frozen:
        p.requires_grad_(False)
    try:
        for epoch in range(1, opt.sup_epochs + 1):
            losses = []
            for _, images, labels in loader:
                x = _device_normalize(torch.as_tensor(images), norm)
                pred, _ = model(x)
                loss = custom_ce_loss(pred, torch.as_tensor(labels))
                sgd.zero_grad(set_to_none=False)
                loss.backward()
                sgd.step()
                losses.append(float(loss.detach()))
            print(f"pretrain epoch {epoch}: loss {np.mean(losses):.4f}")
    finally:
        for p in frozen:
            p.requires_grad_(True)
        for p in head:
            p.grad = None
    return state


def _records_and_plots(save_folder, records):
    """loss/acc history + PNG plots (best-effort: matplotlib may be
    missing)."""
    np.save(os.path.join(save_folder, "loss_acc_records.npy"), records,
            allow_pickle=True)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        for key in ("loss", "train_acc", "test_acc"):
            if not records.get(key):
                continue
            plt.figure()
            plt.plot(records[key])
            plt.xlabel("epoch")
            plt.ylabel(key)
            plt.savefig(os.path.join(save_folder, f"{key}.png"))
            plt.close()
    except Exception as e:  # plotting is best-effort observability
        print(f"plotting skipped: {e}")


def _check_single_device(opt, dev: torch.device) -> None:
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(f"a multi-process run {_NOT_PORTED}")
    if getattr(opt, "device_data", False):
        raise NotImplementedError(
            f"--device_data (device-resident data and augmentation) "
            f"{_NOT_PORTED}")
    mesh_opt = str(getattr(opt, "mesh", "off"))
    if mesh_opt != "off":
        n_visible = torch.cuda.device_count() if dev.type == "cuda" else 1
        want = n_visible if mesh_opt == "auto" else int(mesh_opt)
        if want > 1:
            raise NotImplementedError(
                f"--mesh {mesh_opt} ({want} devices): the multi-device path "
                f"{_NOT_PORTED}; pass --mesh off to run on one device")


def run_training(opt) -> dict:
    """The driver's run.  Returns the records: per-epoch ``loss``,
    ``train_acc``, ``epoch_s`` (the step loop's seconds, ending in a
    device sync) and ``cg_iters`` (mean forward + adjoint CG iterations a
    step, with ``--gl_solver cg``), ``steps_per_epoch``, every eval's
    ``test_acc`` and its transductive ``eval`` stats, and the loader's
    augmentation backend (``loader_backend``)."""
    if opt.dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --dev cpu to run on "
                           "the CPU")
    dev = resolve_device(opt.dev)
    _check_single_device(opt, dev)
    rng_np = np.random.default_rng(opt.seed)
    spec = load_dataset(opt.dataset, allow_synthetic_fallback=True,
                        **synth_kwargs_from_opt(opt))
    num_classes = spec.num_classes

    sup_tf = Transform(spec.name if spec.name in
                       ("mnist", "fashion_mnist", "cifar10", "cifar100",
                        "miniimagenet", "synthetic") else "synthetic",
                       "eval" if opt.augment_type_sup == "no"
                       else opt.augment_type_sup)
    eval_tf = Transform(sup_tf.dataset, "eval")

    ds = ScoredDataset(spec)
    # uint8 batches, normalized on the device; the producer thread copies
    # each batch to the device one step ahead
    loader = BatchLoader(spec.train_images, spec.train_labels,
                         opt.batch_size, sup_tf, seed=opt.seed,
                         workers=opt.num_workers, emit="uint8",
                         to_device=dev)
    step_norm = (sup_tf.mean, sup_tf.std)
    if len(loader) == 0:
        raise ValueError(
            f"batch_size {opt.batch_size} exceeds train set {len(ds)}")

    model = BuildNet(name=opt.model, head=opt.head_type,
                     feat_dim=opt.embedding_dim, num_classes=num_classes,
                     softmax=not opt.no_softmax,
                     dtype=torch.bfloat16 if opt.bf16 else torch.float32,
                     generator=torch.Generator().manual_seed(opt.seed),
                     in_channel=spec.image_shape[-1])
    schedule = make_lr_schedule(
        opt.learning_rate, opt.epochs, len(loader), cosine=opt.cosine,
        lr_decay_rate=opt.lr_decay_rate, lr_decay_epochs=opt.lr_decay_epochs,
        warm=opt.warm, warm_epochs=getattr(opt, "warm_epochs", 10),
        warmup_from=getattr(opt, "warmup_from", 1e-2),
        warmup_to=getattr(opt, "warmup_to", None))
    state = create_train_state(model, schedule, device=dev, adam=opt.Adam,
                               momentum=opt.momentum,
                               weight_decay=opt.weight_decay)
    # the checkpoint only warms the weights (and, for a checkpoint of this
    # package, the optimizer and schedule position); the epoch-loop offset
    # comes from --start_epochs (resume = pass both)
    start_epoch = opt.start_epochs
    if opt.cp_load_path != "no":
        state, ckpt_epoch = restore_checkpoint(opt.cp_load_path, state)
        print(f"Successfully loaded checkpoint from {opt.cp_load_path} "
              f"(epoch {ckpt_epoch})")
        if ckpt_epoch and ckpt_epoch > 0 and start_epoch == 0:
            print(f"note: checkpoint is at epoch {ckpt_epoch} but "
                  "--start_epochs is 0 — weights are warmed and the epoch "
                  f"loop restarts at 1; to RESUME pass --start_epochs "
                  f"{ckpt_epoch} as well")

    # the tau convention: the train step passes --temp as tau to the GL op,
    # the transductive eval uses --tau
    grad_warn = getattr(opt, "grad_warn", 10.0) or None
    gl_step = make_gl_train_step(num_classes, tau=opt.temp,
                                 epsilon=opt.epsilon, k=opt.knn_k,
                                 solver=opt.gl_solver,
                                 score_type=opt.gl_score_type,
                                 norm=step_norm, device=dev)
    mlp_step = make_mlp_train_step(norm=step_norm, device=dev)

    # --ds_stepsize strides only the pool the initial class-uniform base
    # sample is drawn from; the train/test splits and later score-based
    # refreshes use the full data
    if getattr(opt, "ds_stepsize", 1) > 1:
        pool_imgs, pool_labels = downsample_by_stride(
            spec.train_images, spec.train_labels, opt.ds_stepsize)
        pool = ScoredDataset(spec, images=pool_imgs, labels=pool_labels)
        base_imgs, base_labels, base_sel = pool.select_base(
            opt.num_train, "random", rng_np, return_indices=True)
        # pool row i is full-train row i * stepsize
        base_sel = base_sel * opt.ds_stepsize
    else:
        base_imgs, base_labels, base_sel = ds.select_base(
            opt.num_train, "random", rng_np, return_indices=True)
    records = {"loss": [], "train_acc": [], "test_acc": [], "epoch_s": [],
               "cg_iters": [], "eval": [], "steps_per_epoch": len(loader),
               "loader_backend": loader.backend}
    print(f"data: {spec.name} {tuple(spec.image_shape)}, "
          f"{len(spec.train_labels)} train / {len(spec.test_labels)} test, "
          f"{len(loader)} steps an epoch, {loader.backend} augmentation")

    edges_per_step = 2 * (opt.num_train + opt.batch_size) * opt.knn_k

    # one cache across all of this run's transductive evals (permutation
    # reuse, sticky budgets; every solve starts cold, see EvalGraphCache)
    eval_cache = None if getattr(opt, "no_eval_cache", False) \
        else EvalGraphCache()
    eval_norm = (eval_tf.mean, eval_tf.std)

    def evaluate():
        # the gl branch reports the transductive accuracy; the mlp branch
        # also runs the transductive eval (discarded, as in the reference)
        # and reports test_network with the MLP predictor
        stats = {}
        tacc = test_gl_transductive(
            state, base_imgs, base_labels, spec.test_images,
            spec.test_labels, eval_tf.normalize, num_classes,
            train_images=spec.train_images, knn_num=50, epsilon=opt.epsilon,
            tau=opt.tau, norm=eval_norm, cache=eval_cache, device=dev,
            stats=stats)
        records["eval"].append(dict(stats, acc=tacc))
        if opt.sup_train_type == "mlp":
            return test_network(
                state, base_imgs, base_labels, spec.test_images,
                spec.test_labels, num_classes, tau=opt.temp,
                epsilon=opt.epsilon, k=opt.knn_k,
                batch_size=min(opt.test_batch_size, len(spec.test_images)),
                solver=opt.gl_solver, predictor="MLP", norm=eval_norm,
                device=dev)
        return tacc

    def feature_viz(save_dir):
        """Embed the train-split features (subsampled to --viz_max_n) into
        ``save_dir`` with the current base points appended and starred.
        Best-effort: never fails the run."""
        cap = int(getattr(opt, "viz_max_n", 10000))
        if cap == 0:       # 0 = skip visualizations (negative = no cap)
            return
        try:
            from ..evalx import visualize

            encode_step = make_encode_step(norm=eval_norm, device=dev)
            n_tr = len(spec.train_images)
            if n_tr > cap > 0:
                rng_v = np.random.default_rng(opt.seed + 733)
                sel = np.sort(rng_v.choice(n_tr, cap, replace=False))
            else:
                sel = np.arange(n_tr)
            train_f = encode_dataset(encode_step, state,
                                     spec.train_images[sel])
            base_f = encode_dataset(encode_step, state, base_imgs)
            feats = torch.cat([train_f, base_f]).float().cpu().numpy()
            labels_v = np.concatenate([spec.train_labels[sel], base_labels])
            base_mask = np.zeros(len(feats), bool)
            base_mask[len(train_f):] = True
            visualize(feats, labels_v, save_dir, base_mask, tsne=opt.TSNE)
        except Exception as e:  # visualization is best-effort observability
            print(f"visualization skipped: {e}")

    # epoch -1 eval before the MLP-head pretrain, only when it runs
    if opt.sup_epochs > 0:
        records["test_acc"].append(evaluate())
        state = pretrain_linear(state, loader, opt, norm=step_norm)

    # epoch-0 eval
    records["test_acc"].append(evaluate())

    # device trace of one full epoch: GLL_PROFILE_DIR=/path GLL_PROFILE_EPOCH=2
    profile_dir = os.environ.get("GLL_PROFILE_DIR")
    profile_epoch = int(os.environ.get("GLL_PROFILE_EPOCH", "1"))

    for epoch in range(start_epoch + 1, opt.epochs + 1):
        t_epoch = time.time()
        losses, accs = AverageMeter(), AverageMeter()
        batch_time, data_time = AverageMeter(), AverageMeter()
        cg_iters = AverageMeter()
        tput = Throughput(edges_per_step)
        end = time.time()
        # the metrics and scores stay device tensors; reading them every
        # step would serialize each step on the device-to-host copy, so
        # they are read in one stacked copy at print boundaries and at the
        # end of the epoch, and consecutive steps pipeline
        pending = []          # (metrics dict of device scalars, n_labels)
        pending_scores = []   # (dataset indices, device scores)

        def flush_metrics():
            if not pending:
                return
            keys = ["loss", "acc", "params_finite", "grad_norm", "out_norm",
                    "cg_iters"]
            rows = torch.stack([
                torch.stack([m[key].float().reshape(()) if key in m
                             else m["loss"].new_zeros((), dtype=torch.float)
                             for key in keys])
                for m, _ in pending]).cpu().numpy()
            for (m, n_lab), row in zip(pending, rows):
                losses.update(float(row[0]), n_lab)
                accs.update(float(row[1]), n_lab)
                # the per-step parameter NaN sweep, computed on the device
                # inside the step and read here
                if not bool(row[2]):
                    print("nan value")
                if "out_norm" in m:
                    warn_exploding_grad(float(row[3]), float(row[4]),
                                        grad_warn)
                if "cg_iters" in m:
                    cg_iters.update(float(row[5]))
            pending.clear()

        # one epoch's worth of re-augmented base batches, produced and
        # copied to the device one step ahead; the fixed count keeps the
        # augmentation RNG stream identical across base refreshes
        base_iter = (loader.base_batches(base_imgs, base_labels)
                     if opt.sup_train_type == "gl" else None)
        with trace_steps(profile_dir, enabled=epoch == profile_epoch):
            for idx, (indices, images, labels) in enumerate(loader):
                data_time.update(time.time() - end)
                if opt.sup_train_type == "gl":
                    base_x, base_y = next(base_iter)
                    state, metrics, scores = gl_step(state, base_x, base_y,
                                                     images, labels)
                    if (epoch % opt.gl_update_base_epochs == 0
                            and opt.gl_update_base_mode == "score"):
                        pending_scores.append((indices, scores))
                else:
                    state, metrics = mlp_step(state, images, labels)
                pending.append((metrics, len(labels)))
                tput.step()
                batch_time.update(time.time() - end)
                end = time.time()
                if (idx + 1) % opt.print_freq_ss == 0:
                    flush_metrics()
                    print(f"Train: [{epoch}][{idx + 1}/{len(loader)}]\t"
                          f"BT {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                          f"DT {data_time.val:.3f} ({data_time.avg:.3f})\t"
                          f"loss {losses.val:.3f} ({losses.avg:.3f})\t"
                          f"edges/s {tput.edges_per_s:.3e}")
                    sys.stdout.flush()
                    end = time.time()
            flush_metrics()
        records["epoch_s"].append(time.time() - t_epoch)
        # score updates only feed the per-epoch base refresh below: one copy
        if pending_scores:
            all_scores = torch.cat([s for _, s in pending_scores])
            ds.update_scores(np.concatenate([i for i, _ in pending_scores]),
                             all_scores.float().cpu().numpy())

        records["loss"].append(losses.avg)
        records["train_acc"].append(accs.avg)
        if cg_iters.count:
            records["cg_iters"].append(cg_iters.avg)
        print(f"epoch {epoch}, total time {time.time() - t_epoch:.2f}, "
              f"loss {losses.avg:.4f}, train acc {accs.avg:.4f}")

        # base refresh
        if (opt.sup_train_type == "gl"
                and epoch % opt.gl_update_base_epochs == 0):
            base_imgs, base_labels, base_sel = ds.select_base(
                opt.num_train, opt.gl_update_base_mode, rng_np,
                return_indices=True)

        if epoch % opt.plot_freq_ss == 0 or epoch == opt.epochs:
            records["test_acc"].append(evaluate())
            save_checkpoint(os.path.join(opt.save_folder, "ckpt"), state,
                            epoch, opt)
            _records_and_plots(opt.save_folder, records)
            # per-interval feature embedding; the final epoch's embedding
            # lands after the loop
            if epoch % opt.plot_freq_ss == 0 and epoch != opt.epochs:
                feature_viz(os.path.join(opt.save_folder,
                                         f"ckpt_epoch_{epoch}"))

    save_checkpoint(os.path.join(opt.save_folder, "last"), state, opt.epochs,
                    opt)
    _records_and_plots(opt.save_folder, records)
    feature_viz(os.path.join(opt.save_folder, f"ckpt_epoch_{opt.epochs}"))
    loader.close()
    return records


def main(argv=None):
    opt = parse_option(argv)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    logger = FileLogger(os.path.join(opt.save_folder,
                                     f"output_record_{stamp}.txt"))
    sys.stdout = logger
    try:
        return run_training(opt)
    finally:
        sys.stdout = logger.terminal
        logger.close()


if __name__ == "__main__":
    main()
