"""Meshes of ranks and the collectives the multi-device paths use.

Twin of ``graphlearninglayer_tpu/parallel/mesh.py``.  A JAX mesh names the
devices of one program, and GSPMD inserts the collectives that a sharding
implies.  In the port every rank is a process with one device, and the
code names its collectives itself.  So a :class:`Mesh` here lays the ranks
of a ``torch.distributed`` process group out on named axes (``ranks`` plays
the part of the JAX mesh's ``devices``), carries the group and this rank's
device, and runs the few collectives of the sharded train steps, the
sharded KNN and the sharded solves over the whole group.  The JAX module's
``shard`` / ``replicate`` / ``P`` build XLA sharding annotations and have
no PyTorch counterpart: a sharded function of the port takes the full
(replicated) input on every rank and slices its own share.

A mesh of one rank with no group (``make_mesh(1)`` outside a group) runs
every collective as the identity, so the sharded code runs unchanged on
one device.  A world of one inside a group still goes through the
backend's collectives.

The sharded train steps need two differentiable collectives
(:func:`gather_rows`, :func:`all_reduce_sum`) and a BatchNorm whose
statistics span every rank's rows (:class:`CrossRankBatchNorm2d`), which
GSPMD gives the JAX steps for free.  ``torch.nn.SyncBatchNorm`` would do
the latter on the card but refuses CPU tensors, so the port has its own,
which runs the same on CPU ranks over gloo and on cards over NCCL.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

__all__ = ["Mesh", "make_mesh", "gather_rows", "all_reduce_sum",
           "CrossRankBatchNorm2d", "convert_cross_rank_bn", "RowShard"]


class Mesh:
    """The ranks of a process group on named axes.

    ``axis_names``: the axes; ``ranks``: an int array of the global ranks,
    one axis each; ``shape``: axis name -> size, as a JAX mesh's;
    ``group``: the process group (None for a lone rank); ``device``: this
    rank's device; ``rank`` and ``size``: this rank's index in the group and
    the group's size.  The collectives below span the whole group: a
    sharded function takes an axis that covers every rank.
    """

    def __init__(self, axis_names, ranks: np.ndarray, device, group=None):
        self.axis_names = tuple(axis_names)
        self.ranks = np.asarray(ranks)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{len(self.axis_names)} axes for ranks of "
                             f"shape {self.ranks.shape}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.device = torch.device(device)
        self.group = group
        self.size = int(self.ranks.size)
        self.rank = dist.get_rank(group) if group is not None else 0
        self.backend = dist.get_backend(group) if group is not None else None

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank} of {self.size}, "
                f"{self.backend or 'no group'}, {self.device})")

    def axis_size(self, axis: str) -> int:
        """Size of ``axis``, which must span every rank of the mesh."""
        if self.shape.get(axis) != self.size:
            raise ValueError(f"axis {axis!r} of mesh {self.shape} does not "
                             f"span its {self.size} ranks")
        return self.size

    # -- collectives over the whole group --------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks, in place; returns ``t``."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-shape ``t`` stacked along dim 0 in rank order."""
        if self.group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def all_to_all(self, t: torch.Tensor, send_counts, recv_counts
                   ) -> torch.Tensor:
        """Rows ``t`` cut into consecutive pieces of ``send_counts[q]`` rows
        for rank q; returns the pieces received, ``recv_counts[p]`` rows from
        rank p, concatenated in rank order."""
        if self.group is None:
            return t
        out = t.new_empty((int(sum(recv_counts)),) + tuple(t.shape[1:]))
        dist.all_to_all_single(out, t.contiguous(),
                               [int(c) for c in recv_counts],
                               [int(c) for c in send_counts],
                               group=self.group)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` from rank ``src`` on every rank, in place; returns ``t``."""
        if self.group is not None:
            dist.broadcast(t, src, group=self.group)
        return t

    def broadcast_module(self, module: torch.nn.Module,
                         src: int = 0) -> None:
        """Rank ``src``'s parameters and buffers on every rank."""
        if self.group is None:
            return
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                self.broadcast(t.data, src)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 whose backward takes this rank's rows of the
    incoming gradient.  For a loss that every rank computes identically from
    the gathered rows (the sharded train steps), that slice is the loss's
    exact gradient with respect to this rank's rows, and no collective is
    needed on the way back."""

    @staticmethod
    def forward(ctx, t, mesh, sizes):
        ctx.mesh, ctx.sizes = mesh, sizes
        m = max(sizes)
        pad = m - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        full = mesh.all_gather(t)
        return torch.cat([full[r * m:r * m + s]
                          for r, s in enumerate(sizes)])

    @staticmethod
    def backward(ctx, grad):
        lo = sum(ctx.sizes[:ctx.mesh.rank])
        return grad[lo:lo + ctx.sizes[ctx.mesh.rank]], None, None


def gather_rows(mesh: Mesh, t: torch.Tensor, sizes) -> torch.Tensor:
    """The ranks' row blocks of ``t`` (``sizes[r]`` rows on rank r)
    concatenated in rank order, differentiable (see ``_GatherRows``); on
    a lone rank, ``t`` itself."""
    if mesh.group is None:
        return t
    return _GatherRows.apply(t, mesh, tuple(int(s) for s in sizes))


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks whose backward sums the incoming gradients over
    the ranks: each rank's input feeds every rank's result."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone()), None


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ranks."""
    return _AllReduce.apply(t, mesh)


class CrossRankBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode statistics are those of the
    whole batch, every rank's rows together: the per-channel sum, then the
    sum of squared deviations from the global mean, each all-reduced with
    autograd (two passes, as accurate as one device's).  Running statistics
    follow ``nn.BatchNorm2d``'s convention (momentum, unbiased running
    variance, ``num_batches_tracked``).  In eval mode, without a mesh or on
    a mesh of one rank (whose rows are the whole batch) it is
    ``nn.BatchNorm2d``, so a world of one steps exactly as one device does.
    Made by :func:`convert_cross_rank_bn`, which keeps the parameters,
    buffers and state-dict names."""

    mesh: "Mesh | None" = None

    def forward(self, x):
        if not self.training or self.mesh is None or self.mesh.size == 1:
            return super().forward(x)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dims = [0] + list(range(2, x.dim()))
        c = x.shape[1]
        stats = all_reduce_sum(self.mesh, torch.cat(
            [x.sum(dims), x.new_full((1,), x.numel() // c)]))
        total = stats[c]
        mean = stats[:c] / total
        xc = x - mean.reshape(shape)
        var = all_reduce_sum(self.mesh, (xc * xc).sum(dims)) / total
        y = xc * torch.rsqrt(var + self.eps).reshape(shape)
        if self.affine:
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (self.momentum if self.momentum is not None
                     else 1.0 / float(self.num_batches_tracked))
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(
                    m * var.detach() * total / (total - 1))
        return y


def convert_cross_rank_bn(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Turn every ``nn.BatchNorm2d`` inside ``module`` into a
    :class:`CrossRankBatchNorm2d` over ``mesh``, in place: the layer keeps
    its parameters (and so the optimizer's references to them), its buffers
    and its state-dict names, so a checkpoint loads either way.  Returns
    ``module``."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.__class__ = CrossRankBatchNorm2d
            m.mesh = mesh
    return module


class RowShard:
    """A sharded function's view of its n rows (the sharded train steps',
    the sharded attack's): ``sizes[r]`` consecutive rows on rank r, this
    rank's from ``lo`` to ``hi``."""

    def __init__(self, mesh: Mesh, n: int):
        self.mesh = mesh
        self.sizes = [n // mesh.size + (r < n % mesh.size)
                      for r in range(mesh.size)]
        self.lo = sum(self.sizes[:mesh.rank])
        self.hi = self.lo + self.sizes[mesh.rank]

    def begin(self, model: nn.Module) -> None:
        convert_cross_rank_bn(model, self.mesh)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_rows(self.mesh, t, self.sizes)

    def reduce_grads(self, model: nn.Module) -> None:
        """Sum the ranks' parameter gradients (one all-reduce a dtype)."""
        grads = [p.grad for p in model.parameters()]
        for dt in {g.dtype for g in grads}:
            same = [g for g in grads if g.dtype == dt]
            flat = self.mesh.all_reduce(torch.cat([g.reshape(-1)
                                                   for g in same]))
            for g, part in zip(same, flat.split([g.numel() for g in same])):
                g.copy_(part.view_as(g))


def make_mesh(n_devices: int | None = None,
              axes: tuple[str, ...] = ("data",),
              shape: tuple[int, ...] | None = None, device=None) -> Mesh:
    """A mesh over the ranks of the process group (or over this process
    alone when there is none).

    ``n_devices`` must be the group's size: a mesh spans the whole group.
    With one axis every rank goes to it; with two and no ``shape`` the
    ranks are split as evenly as possible, the leading axis the larger, as
    in the JAX twin.  ``device``: this rank's device outside a group (the
    card unless the caller asks for the CPU; the group's rank device inside
    one)."""
    from .multihost import rank_device

    in_group = dist.is_initialized()
    n = dist.get_world_size() if in_group else 1
    if n_devices is not None and n_devices != n:
        raise ValueError(f"requested a {n_devices}-device mesh, but the "
                         f"process group has {n} rank(s)")
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            a = int(np.floor(np.sqrt(n)))
            while n % a:
                a -= 1
            shape = (n // a, a)
        else:
            raise ValueError("provide an explicit shape for >2 axes")
    if in_group:
        device = rank_device() if device is None else device
    elif device is None:
        device = "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for a "
                           "CPU mesh")
    return Mesh(axes, np.arange(n).reshape(shape), device,
                dist.group.WORLD if in_group else None)
