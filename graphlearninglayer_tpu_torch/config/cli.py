"""CLI flags of the drivers.

Twin of ``graphlearninglayer_tpu/config/cli.py``: the same flags, defaults
and derived options (``save_folder`` naming, ``lr_decay_epochs`` parsing,
``warmup_*``, ``epochs += start_epochs``).  Flags whose machinery has no
driver yet (the pseudo-label / CPL family) are accepted and threaded
through.  Two deliberate differences from the JAX package:

  * ``--dev`` is the torch device: ``cuda`` (the default) or ``cpu``.  It
    selects where the driver runs and touches no global state.
  * ``--mesh`` accepts ``auto``, ``off`` or a positive device count; the
    driver runs one device (``auto`` with one visible card runs as
    ``off``), and a count above 1 raises there, as the multi-device paths
    are not ported yet.
"""
from __future__ import annotations

import argparse
import math
import os

__all__ = ["str_or_float", "parse_option"]


def str_or_float(value: str):
    """'auto' stays a string; anything numeric becomes float."""
    try:
        return float(value)
    except ValueError:
        return value


def _mesh_arg(value: str) -> str:
    """'auto', 'off' or a positive device count."""
    if value in ("auto", "off") or (value.isdigit() and int(value) > 0):
        return value
    raise argparse.ArgumentTypeError(
        f"--mesh takes 'auto', 'off' or a positive device count, not "
        f"{value!r}")


def parse_option(argv=None):
    parser = argparse.ArgumentParser("argument for training")

    parser.add_argument("--dev", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="torch device: cuda (the default) or cpu")

    parser.add_argument("--print_freq_sup", type=int, default=1)
    parser.add_argument("--print_freq_ss", type=int, default=10)
    parser.add_argument("--plot_freq_sup", type=int, default=15)
    parser.add_argument("--plot_freq_ss", type=int, default=15)
    parser.add_argument("--batch_size", type=int, default=1250)
    parser.add_argument("--test_batch_size", type=int, default=1250)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--cp_load_path", type=str, default="no",
                        help="path to the checkpoint; 'no' trains from scratch")
    parser.add_argument("--train_mode", type=str, default="Sup_and_SS",
                        choices=["Sup_and_SS", "Sup_only", "SS_only"])
    parser.add_argument("--train_prefix", type=str, default="")
    parser.add_argument("--no_softmax", action="store_true")
    # run the encoder in bfloat16 (parameters and the head/normalize/graph
    # math stay float32)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 encoder compute (autocast)")
    # keep the uint8 training set device-resident and augment inside the
    # step (not ported yet: the driver raises)
    parser.add_argument("--device_data", action="store_true",
                        help="device-resident dataset + on-device "
                             "augmentation (per-step transfers are index/"
                             "label vectors only)")
    parser.add_argument("--start_epochs", type=int, default=0)

    # optimization
    parser.add_argument("--learning_rate", type=float, default=0.01)
    parser.add_argument("--lr_decay_epochs", type=str,
                        default="400,500,600,700,800,900")
    parser.add_argument("--lr_decay_rate", type=float, default=0.1)
    parser.add_argument("--weight_decay", type=float, default=5e-4)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--cosine", action="store_true")
    parser.add_argument("--warm", action="store_true")
    parser.add_argument("--adjust_lr", action="store_true")
    parser.add_argument("--Adam", action="store_true")

    # model / dataset
    parser.add_argument("--model", type=str, default="resnet18")
    parser.add_argument("--dataset", type=str, default="cifar10",
                        choices=["cifar10", "cifar100", "mnist",
                                 "fashion_mnist", "miniimagenet",
                                 "synthetic"])
    parser.add_argument("--ds_stepsize", type=int, default=1)
    parser.add_argument("--synth_n_train", type=int, default=4096,
                        help="train-set size when the synthetic dataset (or "
                             "a synthetic fallback) is used")
    parser.add_argument("--synth_n_test", type=int, default=1024)
    parser.add_argument("--synth_sep", type=float, default=None,
                        help="enable the HARD synthetic generator (latent "
                             "Gaussian mixture) with this class-separation "
                             "scale; smaller = more class overlap. Unset = "
                             "legacy clean generator")
    parser.add_argument("--synth_modes", type=int, default=3,
                        help="intra-class modes of the hard synthetic "
                             "generator (with --synth_sep)")
    parser.add_argument("--synth_label_noise", type=float, default=0.0,
                        help="fraction of synthetic TRAIN labels flipped "
                             "to a random other class")
    parser.add_argument("--synth_noise", type=float, default=0.35,
                        help="pixel-noise std of the hard synthetic "
                             "generator (with --synth_sep)")
    parser.add_argument("--data_folder", type=str, default=None)
    parser.add_argument("--size", type=int, default=32)
    parser.add_argument("--augment_type_sup", type=str, default="strong",
                        choices=["no", "weak", "strong"])
    parser.add_argument("--augment_type_ss", type=str, default="strong",
                        choices=["no", "weak", "strong"])
    parser.add_argument("--num_train", type=int, default=250)

    # method
    parser.add_argument("--sup_method", type=str, default="SupCE",
                        choices=["SupCE", "SupCon"])
    parser.add_argument("--embedding_dim", type=int, default=128)
    parser.add_argument("--head_type", type=str, default="mlp",
                        choices=["mlp", "linear", "no"])
    parser.add_argument("--TSNE", action="store_true")
    parser.add_argument("--viz_max_n", type=int, default=10000,
                        help="cap on train-split points embedded per "
                             "interval visualization (the reference embeds "
                             "the full split; the "
                             "host-side t-SNE fallback is superlinear in n "
                             "so the split is subsampled; 0 skips the "
                             "visualizations entirely, negative = no cap)")

    # general parameters
    parser.add_argument("--temp", type=float, default=0.07,
                        help="temperature; passed as tau to the GL op in the "
                             "FullySup path (reference FullySup.py:156)")
    parser.add_argument("--tau", type=float, default=1e-8,
                        help="tau for the transductive eval solve")
    parser.add_argument("--epsilon", type=str_or_float, default=1,
                        help="'auto' or float bandwidth")
    parser.add_argument("--alpha", type=float, default=1)

    # uncertainty parameters
    parser.add_argument("--beta", type=float, default=0)
    parser.add_argument("--n_samples_ve", type=int, default=50)

    # supervised only
    parser.add_argument("--sup_train_type", type=str, default="no",
                        choices=["no", "gl", "mlp"])
    parser.add_argument("--pretrain_lr_multiply", type=int, default=1)
    parser.add_argument("--sup_epochs", type=int, default=0)
    parser.add_argument("--gl_update_base_epochs", type=int, default=1)
    parser.add_argument("--gl_update_base_mode", type=str, default="score",
                        choices=["random", "score"])
    parser.add_argument("--gl_score_type", type=str, default="entropy",
                        choices=["entropy", "l2"])

    # alternative pseudo-label training (machinery flags)
    parser.add_argument("--mlp_train_steps", type=int, default=1)
    parser.add_argument("--gl_train_steps", type=int, default=1)
    parser.add_argument("--thresh", type=float, default=0.9)
    parser.add_argument("--thresh_mlp", type=float, default=0.95)
    parser.add_argument("--DV_plabels", action="store_true")
    parser.add_argument("--plabel_update_epochs", type=int, default=5)
    parser.add_argument("--cpl", action="store_true")
    parser.add_argument("--cpl_nonlinear", action="store_true")
    parser.add_argument("--cpl_warmup", action="store_true")

    # solver knobs
    parser.add_argument("--knn_k", type=int, default=25,
                        help="neighbors per node in the per-batch graph")
    parser.add_argument("--gl_solver", type=str, default="cholesky",
                        choices=["cholesky", "cg"])

    # multi-device execution (one device only so far)
    parser.add_argument("--mesh", type=_mesh_arg, default="auto",
                        help="device mesh for the train step and large-n "
                             "eval: 'auto' (all visible devices when >1), "
                             "'off', or an explicit device count")
    parser.add_argument("--no_eval_cache", action="store_true",
                        help="disable the cross-eval transductive graph "
                             "cache (permutation reuse + sticky tile "
                             "budgets)")
    parser.add_argument("--shard_eval_min_n", type=int, default=20000,
                        help="route the transductive eval through the edge-"
                             "partitioned multi-device solver when the graph "
                             "has at least this many nodes (and --mesh is on)")
    parser.add_argument("--grad_warn", type=float, default=10.0,
                        help="exploding-gradient warn threshold in the graph "
                             "op backward; 0 disables")

    # other
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--class_rand_sample", action="store_true")
    parser.add_argument("--sup_train_time", type=int, default=10)
    parser.add_argument("--print_all_parameters", action="store_true")

    opt = parser.parse_args(argv)

    opt.epochs = opt.epochs + opt.start_epochs
    opt.class_uni_sample = not opt.class_rand_sample

    if opt.data_folder is None:
        opt.data_folder = "./datasets/"
    opt.model_path = f"./save/{opt.train_prefix}_{opt.train_mode}"
    if opt.sup_train_type != "no":
        opt.model_path = f"{opt.model_path}_{opt.sup_train_type}"

    opt.lr_decay_epochs = [int(it) for it in
                           str(opt.lr_decay_epochs).split(",")]

    opt.model_name = "{}_{}_bsz_{}_method_{}_{}_supaug_{}_ssaug_{}".format(
        opt.sup_method, opt.model, opt.batch_size, opt.sup_method,
        opt.train_mode, opt.augment_type_sup, opt.augment_type_ss)
    if opt.cosine:
        opt.model_name = f"{opt.model_name}_cosine"
    if opt.warm:
        opt.model_name = f"{opt.model_name}_warm"
        opt.warmup_from = 1e-2
        opt.warm_epochs = 10
        if opt.cosine:
            eta_min = opt.learning_rate * (opt.lr_decay_rate ** 3)
            opt.warmup_to = eta_min + (opt.learning_rate - eta_min) * (
                1 + math.cos(math.pi * opt.warm_epochs / opt.epochs)) / 2
        else:
            opt.warmup_to = opt.learning_rate
    else:
        opt.warmup_from = 1e-2
        opt.warm_epochs = 10
        opt.warmup_to = opt.learning_rate

    opt.save_folder = os.path.join(opt.model_path, opt.model_name)
    print(f"save_folder: {opt.save_folder}")
    os.makedirs(opt.save_folder, exist_ok=True)
    return opt
