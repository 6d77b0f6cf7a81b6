"""Evaluation harnesses: per-batch GL / MLP eval and the transductive eval
over the whole dataset.

Twin of ``graphlearninglayer_tpu/evalx/harness.py`` (``encode_dataset``,
``test_network`` and the single-device branch of ``test_gl_transductive``).
The transductive eval encodes base + train + test images on the device,
then builds one k=50 graph over all of them and runs one CG solve
(``ops.transductive_laplace``); accuracy on the test slice.

Not ported yet: ``encode_dataset_resident`` and the sharded eval (``mesh=``,
``resident=`` raise ``NotImplementedError``).
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from ..ops import transductive_laplace
from ..ops.transductive import eval_debug
from ..train.trainer import (TrainState, make_encode_step, make_gl_eval_step,
                             make_mlp_eval_step, resolve_device)

__all__ = ["encode_dataset", "test_network", "test_gl_transductive"]


def encode_dataset(encode_step, state: TrainState, images: np.ndarray,
                   normalize_fn=None, batch_size: int = 1024
                   ) -> torch.Tensor:
    """Features of ``images`` in fixed-size batches: the tail batch is
    padded (rows repeated) to ``batch_size`` and trimmed after.  Returns
    the (n, feat_dim) features as one tensor on the step's device.

    ``normalize_fn=None`` ships chunks as they are (raw uint8 when
    ``encode_step`` was built with ``norm=(mean, std)``)."""
    feats = []
    n = len(images)
    for i in range(0, n, batch_size):
        chunk = images[i:i + batch_size]
        real = len(chunk)
        if real < batch_size:
            chunk = chunk[np.arange(batch_size) % real]
        if normalize_fn is not None:
            chunk = normalize_fn(chunk)
        feats.append(encode_step(state, chunk)[:real])
    return torch.cat(feats)


def test_network(state: TrainState, base_images, base_labels, test_images,
                 test_labels, num_classes: int, tau: float, epsilon="auto",
                 k: int = 25, batch_size: int = 1250,
                 solver: str = "cholesky", normalize_fn=None,
                 predictor: str = "GL", norm=None, tail: str = "exact",
                 device="cuda") -> float:
    """Per-batch network accuracy in percent (the reference's
    test_network).

    predictor='GL': each test batch is classified by the network + graph
    head against the single base batch (pass the driver's ``--temp`` as
    ``tau``).  predictor='MLP': the aux classifier head alone.

    ``tail``: what to do with a final test batch shorter than
    ``batch_size``.  'exact' runs it as a smaller graph (the reference's
    semantics); 'pad' repeats rows up to ``batch_size`` and scores only the
    real rows (the duplicated rows change the tail graph's KNN lists and
    bandwidths, so tail scores deviate from the reference).

    ``norm=(mean, std)``: ship raw uint8 batches and normalize on the
    device; otherwise ``normalize_fn`` runs on the host.  The correct counts
    stay on the device until every batch is dispatched."""
    if tail not in ("exact", "pad"):
        raise ValueError(f"unknown tail mode {tail!r}")
    dev = resolve_device(device)
    if predictor == "GL":
        gl_step = make_gl_eval_step(num_classes, tau, epsilon, k, solver,
                                    norm=norm, device=dev)
    elif predictor == "MLP":
        mlp_step = make_mlp_eval_step(norm=norm, device=dev)
    else:
        raise ValueError(predictor)
    host_norm = normalize_fn if (normalize_fn is not None and norm is None) \
        else (lambda a: a)
    base_x = host_norm(np.asarray(base_images))
    labels = torch.as_tensor(np.asarray(test_labels), device=dev)
    n = len(test_images)
    correct = []
    for i in range(0, n, batch_size):
        chunk = test_images[i:i + batch_size]
        real = len(chunk)
        if real < batch_size and tail == "pad":
            chunk = chunk[np.arange(batch_size) % real]
        x = host_norm(np.asarray(chunk))
        pred = (gl_step(state, base_x, base_labels, x) if predictor == "GL"
                else mlp_step(state, x))
        correct.append(torch.sum(pred[:real] == labels[i:i + real]))
    correct = int(torch.stack(correct).sum()) if correct else 0
    acc = 100.0 * correct / max(n, 1)
    print(f"Test set: Accuracy for {predictor} predictor: {correct}/{n} "
          f"({acc:.2f}%)\n")
    return acc


def test_gl_transductive(state: TrainState, base_images, base_labels,
                         test_images, test_labels, normalize_fn,
                         num_classes: int, train_images=None,
                         knn_num: int = 50, epsilon="auto",
                         tau: float = 1e-8, batch_size: int = 1024,
                         norm=None, mesh=None, shard_min_n: int = 20000,
                         resident=None, cache=None, device="cuda",
                         stats: dict | None = None) -> float:
    """Full transductive eval: features of base + (optional) unlabeled
    train + test, one big k=``knn_num`` graph, CG solve; returns the
    accuracy (percent) on the test slice.

    ``norm=(mean, std)``: raw uint8 batches, normalized on the device
    (``normalize_fn`` is then unused).  ``cache``: an ``EvalGraphCache``
    shared across eval epochs (permutation reuse, sticky budgets; the
    result does not change).  ``stats``: an optional dict the
    eval fills with ``n_nodes``, ``encode_s``, ``solve_s`` (host clock, each
    ending in a device sync), ``cg_iters`` and ``cg_err``.

    ``mesh`` (with ``shard_min_n``) and ``resident`` belong to the sharded
    and device-resident eval paths, which are not ported yet: they
    raise."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: the edge-sharded transductive eval is not ported yet "
            "(ROADMAP.md, section 1, slice 6, item 22)")
    if resident is not None:
        raise NotImplementedError(
            "resident=: the device-resident eval (encode_dataset_resident) "
            "is not ported yet (ROADMAP.md, section 1, slice 6, item 21)")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    encode_step = make_encode_step(norm=norm, device=dev)
    host_norm = normalize_fn if norm is None else None
    parts = [encode_dataset(encode_step, state, base_images, host_norm,
                            batch_size)]
    if train_images is not None:
        parts.append(encode_dataset(encode_step, state, train_images,
                                    host_norm, batch_size))
    parts.append(encode_dataset(encode_step, state, test_images, host_norm,
                                batch_size))
    all_f = torch.cat(parts)
    y = torch.as_tensor(np.eye(num_classes, dtype=np.float32)[base_labels],
                        device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    n_nodes = int(all_f.shape[0])
    # k cannot exceed the node count (self included)
    knn_num = min(knn_num, n_nodes)

    def solve():
        return transductive_laplace(all_f, y, knn_num=knn_num,
                                    epsilon=epsilon, tau=tau,
                                    return_info=True, cache=cache)

    if eval_debug():
        # snapshot the eval features before the solve, so that a device
        # fault cannot take them with it (a ring of two snapshots)
        snap = all_f.cpu().numpy()
        seq = getattr(test_gl_transductive, "_dbg_seq", 0)
        test_gl_transductive._dbg_seq = seq + 1
        tmp = tempfile.gettempdir()
        np.save(os.path.join(tmp, f"gll_eval_debug_{seq % 2}.npy"), snap)
        try:
            u, cg_iters, cg_err = solve()
        except Exception:
            path = os.path.join(tmp, "gll_eval_failure_features.npz")
            extra = {}
            if cache is not None and cache.perm is not None:
                extra = {"cache_perm": cache.perm.cpu().numpy(),
                         "cache_smax": cache.smax or -1,
                         "cache_ovf": cache.ovf_cap or -1}
            np.savez(path, x=snap, y=y.cpu().numpy(), **extra)
            print(f"eval features dumped to {path}")
            raise
    else:
        u, cg_iters, cg_err = solve()
    pred = torch.argmax(u, dim=1).cpu().numpy()[-len(test_images):]
    t2 = time.perf_counter()
    acc = 100.0 * float(np.mean(pred == np.asarray(test_labels)))
    print(f"Test set: Accuracy for GL predictor "
          f"(Num of train data: {len(base_images)})\t: "
          f"{int(acc * len(test_images) / 100)}/{len(test_images)} "
          f"({acc:.2f}%)\n"
          f"  [transductive solve: {cg_iters} CG iters, "
          f"residual {cg_err:.2e}]")
    if stats is not None:
        stats.update(n_nodes=n_nodes, encode_s=t1 - t0, solve_s=t2 - t1,
                     cg_iters=cg_iters, cg_err=cg_err)
    return acc
