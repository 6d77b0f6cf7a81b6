"""Observability primitives: meters, accuracy, throughput, stdout tee.

Twin of ``graphlearninglayer_tpu/utils/meters.py``.  ``parameter_count``
and ``parameters_string`` read an ``nn.Module``'s parameters.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

__all__ = ["AverageMeter", "AverageMeterSet", "Throughput", "topk_accuracy",
           "FileLogger", "parameters_string", "parameter_count",
           "UnifLabelSampler", "drain_correct"]


def drain_correct(preds, labels) -> int:
    """Count correct predictions from a list of device prediction vectors.

    The deferred eval pattern: enqueue every batch first, then copy all
    predictions to the host in one transfer here.  ``labels`` must cover
    the concatenated length."""
    if not preds:
        return 0
    got = torch.cat([torch.as_tensor(p) for p in preds]).cpu().numpy()
    return int(np.sum(got == np.asarray(labels)))


class AverageMeter:
    """Running value/average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        if self.count > 0:
            self.avg = self.sum / self.count


class Throughput:
    """steps/s and edges/s counters over a sliding window."""

    def __init__(self, edges_per_step: int = 0):
        self.edges_per_step = edges_per_step
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1):
        self._steps += n

    @property
    def steps_per_s(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0

    @property
    def edges_per_s(self) -> float:
        return self.steps_per_s * self.edges_per_step


def topk_accuracy(output: np.ndarray, target: np.ndarray,
                  topk=(1,)) -> list[float]:
    """Top-k accuracy in percent."""
    maxk = max(topk)
    pred = np.argsort(-output, axis=1)[:, :maxk]
    correct = pred == target[:, None]
    return [100.0 * float(correct[:, :k].any(axis=1).mean()) for k in topk]


class AverageMeterSet:
    """Named collection of AverageMeters."""

    def __init__(self):
        self.meters: dict[str, AverageMeter] = {}

    def __getitem__(self, key):
        return self.meters[key]

    def update(self, name, value, n=1):
        self.meters.setdefault(name, AverageMeter()).update(value, n)

    def reset(self):
        for meter in self.meters.values():
            meter.reset()

    def values(self, postfix=""):
        return {name + postfix: m.val for name, m in self.meters.items()}

    def averages(self, postfix="/avg"):
        return {name + postfix: m.avg for name, m in self.meters.items()}

    def sums(self, postfix="/sum"):
        return {name + postfix: m.sum for name, m in self.meters.items()}

    def counts(self, postfix="/count"):
        return {name + postfix: m.count for name, m in self.meters.items()}


def parameter_count(module) -> int:
    """Total parameter count of an ``nn.Module``."""
    return sum(p.numel() for p in module.parameters())


def parameters_string(module) -> str:
    """Human-readable per-parameter table + total."""
    lines = []
    total = 0
    for name, p in module.named_parameters():
        count = p.numel()
        total += count
        lines.append(f"  {name:60s} {tuple(p.shape)!s:20s} {count:>10,d}")
    lines.append(f"  {'TOTAL':60s} {'':20s} {total:>10,d}")
    return "\n".join(lines)


class UnifLabelSampler:
    """Epoch index sampler drawing uniformly over label groups
   : N indices per epoch, equal counts
    per non-empty group, with replacement within groups as needed."""

    def __init__(self, n: int, images_lists: list[np.ndarray], seed: int = 0):
        self.n = n
        self.images_lists = [np.asarray(v) for v in images_lists if len(v)]
        self.rng = np.random.default_rng(seed)

    def generate_indexes_epoch(self) -> np.ndarray:
        per = self.n // len(self.images_lists) + 1
        out = np.zeros(per * len(self.images_lists), dtype=np.int64)
        for i, group in enumerate(self.images_lists):
            indexes = self.rng.choice(group, per,
                                      replace=(len(group) <= per))
            out[i * per:(i + 1) * per] = indexes
        self.rng.shuffle(out)
        return out[: self.n]

    def __iter__(self):
        return iter(self.generate_indexes_epoch())

    def __len__(self):
        return self.n


class FileLogger:
    """Tee stdout to a timestamped record file."""

    def __init__(self, path: str):
        self.terminal = sys.stdout
        self.log = open(path, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()
