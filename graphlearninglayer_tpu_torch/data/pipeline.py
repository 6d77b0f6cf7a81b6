"""Host data pipeline: batch iteration, base-set selection, score tracking.

Twin of ``graphlearninglayer_tpu/data/pipeline.py``: shuffled epoch
iteration with per-sample indices, a class-uniform base set served as one
full batch, and ``ScoredDataset``, whose per-sample uncertainty scores
(updated every step from the GL predictions) drive the periodic base-set
refresh ('random' | 'score').

Augmentation runs on the host (the native C++ backend, or PIL).  The same
seed gives byte-identical batches, index streams and base picks as the JAX
package: the port keeps its two seed streams (``rng`` for the epoch order
and the training batches, ``rng_full`` for the base batches), its
per-backend seed draws and its one sequential producer thread.

``to_device``: each batch is copied to that device inside the producer
thread, so the host-to-device copy overlaps the previous step's compute.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from . import native as _native
from .augment import Transform
from .datasets import DatasetSpec

__all__ = ["ScoredDataset", "BatchLoader", "select_base_indices",
           "downsample_by_stride", "TwoCropBatchLoader"]


def downsample_by_stride(images: np.ndarray, labels: np.ndarray,
                         stepsize: int):
    """Keep every ``stepsize``-th sample (the ``--ds_stepsize`` flag)."""
    return images[::stepsize], labels[::stepsize]


def select_base_indices(labels: np.ndarray, num_samples: int,
                        num_classes: int, mode: str = "random",
                        scores: np.ndarray | None = None,
                        rng: np.random.Generator | None = None) -> np.ndarray:
    """Class-uniform base-set selection.

    'random': per-class random draw of num_samples // num_classes.
    'score' : per-class top-scored (most uncertain) samples.
    """
    rng = rng or np.random.default_rng()
    per_class = num_samples // num_classes
    chosen = []
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        if mode == "random":
            chosen.append(rng.permutation(idx)[:per_class])
        elif mode == "score":
            if scores is None:
                raise ValueError("score mode requires scores")
            order = np.argsort(-scores[idx], kind="stable")
            chosen.append(idx[order[:per_class]])
        else:
            raise ValueError(mode)
    return np.concatenate(chosen)


class ScoredDataset:
    """Train-set wrapper with per-sample uncertainty scores."""

    def __init__(self, spec: DatasetSpec, images: np.ndarray | None = None,
                 labels: np.ndarray | None = None):
        self.spec = spec
        self.images = spec.train_images if images is None else images
        self.labels = spec.train_labels if labels is None else labels
        self.scores = np.zeros(len(self.labels), np.float32)

    def __len__(self):
        return len(self.labels)

    def update_scores(self, indices: np.ndarray, scores: np.ndarray):
        self.scores[indices] = scores

    def select_base(self, num_samples: int, mode: str = "random",
                    rng: np.random.Generator | None = None,
                    return_indices: bool = False):
        idx = select_base_indices(self.labels, num_samples,
                                  self.spec.num_classes, mode, self.scores,
                                  rng)
        if return_indices:
            return self.images[idx], self.labels[idx], idx
        return self.images[idx], self.labels[idx]


class BatchLoader:
    """Shuffled epoch iterator yielding (indices, images, labels) with
    host-side augmentation and normalization.

    Drop-last batching with a static batch size.  ``backend``: 'native'
    (the C++ library, data/native.py), 'pil', or 'auto' (native when the
    library builds).  ``emit``: 'normalized' float32 batches or 'uint8'
    for normalization on the device.  ``to_device``: False, or a device
    (True means 'cuda') that the producer thread copies each batch to,
    through pinned memory on a side stream; the copy has finished when the
    batch is yielded.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, transform: Transform,
                 shuffle: bool = True, seed: int = 0, workers: int = 8,
                 backend: str = "auto", prefetch: int = 1,
                 emit: str = "normalized", to_device=False):
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        # a separate stream for full_batch(): it is called from the training
        # loop while the producer thread draws from self.rng, and
        # np.random.Generator is not thread-safe
        self.rng_full = np.random.default_rng((seed + 1) * 0x9E3779B9)
        if backend not in ("auto", "native", "pil"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "auto":
            backend = "native" if _native.native_available() else "pil"
        elif backend == "native" and not _native.native_available():
            raise RuntimeError("native augmentation backend unavailable")
        self.backend = backend
        # the PIL backend augments over a thread pool (PIL releases the GIL
        # for most ops); the native library runs its own threads
        self.pool = (ThreadPoolExecutor(workers)
                     if workers > 0 and backend == "pil" else None)
        # batches prepared ahead by a background thread (0 = synchronous);
        # one sequential producer keeps the augmentation RNG stream, and
        # therefore every batch, identical to the synchronous loader
        self.prefetch = prefetch
        if emit not in ("normalized", "uint8"):
            raise ValueError(f"unknown emit mode {emit!r}")
        self.emit = emit
        if to_device is True:
            to_device = "cuda"
        self.device = torch.device(to_device) if to_device else None
        self._copy_stream = None

    def __len__(self):
        return len(self.labels) // self.batch_size

    def close(self):
        """Shut down the PIL thread pool."""
        if self.pool is not None:
            self.pool.shutdown()
            self.pool = None

    def _augment_batch(self, batch: np.ndarray,
                       rng: np.random.Generator | None = None) -> np.ndarray:
        rng = self.rng if rng is None else rng
        raw = self.emit == "uint8"
        if self.transform.mode == "eval":
            return batch if raw else self.transform.normalize(batch)
        if self.backend == "native":
            t = self.transform
            seeds = rng.integers(0, 2 ** 63, len(batch), dtype=np.uint64)
            out = _native.augment_batch_native(
                batch, seeds, rand_n=t.rand.n, rotation=t.rotation,
                flip=t.flip, pad=t.pad,
                pad_reflect=(t.pad_mode == "reflect"))
            return out if raw else _native.normalize_batch_native(
                out, t.mean, t.std)
        seeds = rng.integers(0, 2 ** 31, len(batch))

        def one(args):
            img, s = args
            return self.transform(img, np.random.default_rng(s))

        if self.pool is not None:
            out = list(self.pool.map(one, zip(batch, seeds)))
        else:
            out = [one(a) for a in zip(batch, seeds)]
        out = np.stack(out)
        return out if raw else self.transform.normalize(out)

    def _put_device(self, arr: np.ndarray):
        """``arr`` on ``self.device`` (unchanged without one).  On a CUDA
        device the copy runs from pinned memory on a side stream, and this
        (producer) thread waits for it, so the pinned buffer is released
        only after the copy; the result is marked as used by the consumer's
        default stream for the caching allocator."""
        if self.device is None:
            return arr
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.to(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        pinned = t.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            out = pinned.to(self.device, non_blocking=True)
        self._copy_stream.synchronize()
        out.record_stream(torch.cuda.default_stream(self.device))
        return out

    def _epoch_iter(self):
        order = (self.rng.permutation(len(self.labels)) if self.shuffle
                 else np.arange(len(self.labels)))
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield (idx, self._put_device(self._augment_batch(self.images[idx])),
                   self._put_device(self.labels[idx]))

    def __iter__(self) -> Iterator[tuple]:
        if self.prefetch <= 0:
            yield from self._epoch_iter()
            return
        yield from _prefetched(self._epoch_iter(), self.prefetch)

    def full_batch(self, images: np.ndarray, labels: np.ndarray):
        """Augment+normalize an explicit set (the base batch is re-augmented
        each step).  Uses its own RNG stream, so it is safe to call while the
        producer thread augments training batches."""
        return self._augment_batch(images, rng=self.rng_full), labels

    def base_batches(self, images: np.ndarray, labels: np.ndarray,
                     count: int | None = None):
        """Prefetched iterator of ``count`` re-augmented base batches (one
        per training step of an epoch; default len(self)).

        The same as calling :meth:`full_batch` ``count`` times, from the
        same ``rng_full`` stream in the same order, but augmentation and the
        device copy run one step ahead in a producer thread.  Producing
        exactly ``count`` batches keeps the RNG stream identical to the
        synchronous path across base-set refreshes: no prefetched draw is
        ever discarded."""
        count = len(self) if count is None else count

        def gen():
            for _ in range(count):
                out, lab = self.full_batch(images, labels)
                yield self._put_device(out), self._put_device(lab)

        if self.prefetch <= 0:
            return gen()
        return _prefetched(gen(), 1)


def _prefetched(it, depth: int):
    """Run ``it`` in a background thread, ``depth`` items ahead.  One
    producer thread keeps the item order and RNG stream identical to
    consuming ``it`` directly.  Closing the generator (or an early
    ``break``) stops the producer promptly via the stop event."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END, _ERR = object(), object()

    def _put(item) -> bool:
        """Stop-aware bounded put; False if the consumer went away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in it:
                if not _put(item):
                    return
            _put(_END)
        except BaseException as e:  # handed to the consumer, which raises
            _put((_ERR, e))

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()


class TwoCropBatchLoader(BatchLoader):
    """Yields n_views independently augmented copies of each batch, for
    contrastive (SupCon/SimCLR) training."""

    def __init__(self, *args, n_views: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_views = n_views

    def _epoch_iter(self):
        order = (self.rng.permutation(len(self.labels)) if self.shuffle
                 else np.arange(len(self.labels)))
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            views = np.stack([self._augment_batch(self.images[idx])
                              for _ in range(self.n_views)], axis=1)
            yield (idx, self._put_device(views),
                   self._put_device(self.labels[idx]))
