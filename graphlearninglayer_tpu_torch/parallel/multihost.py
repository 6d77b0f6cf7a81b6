"""Process-group initialization and spawned ranks.

Twin of ``graphlearninglayer_tpu/parallel/multihost.py``.  Where the JAX
package runs one process a host and lets ``jax.distributed`` span every
host's devices, the port runs one process a rank, each with one device, in
a ``torch.distributed`` process group:

  * :func:`initialize_multihost` joins the group from explicit arguments or,
    failing those, from the variables a launcher such as ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``);
  * :func:`spawn_ranks` starts a world of ranks on this host itself (the
    driver's ``--mesh N`` without a launcher, and the tests), each joining
    through a ``file://`` store in a fresh temporary directory;
  * :func:`global_mesh` lays the whole group out on named axes
    (``parallel/mesh.py``).

The backend follows from where the tensors live: NCCL when every rank of
the host has a card of its own, gloo for CPU ranks and for ranks that
share a card (NCCL refuses two ranks on one device).  A rank's device is
``cuda:{LOCAL_RANK % device_count}`` unless the caller asks for the CPU.  A
failed initialization raises; nothing carries on as a single device.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import traceback
from multiprocessing import connection

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["initialize_multihost", "is_multihost", "global_mesh",
           "rank_device", "spawn_ranks"]

_device: torch.device | None = None


def _env_int(name: str, default=None):
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def _backend(dev: torch.device, local_world: int) -> str:
    if dev.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_multihost(init_method: str | None = None,
                         world_size: int | None = None,
                         rank: int | None = None,
                         local_rank: int | None = None,
                         device=None) -> bool:
    """Join a ``torch.distributed`` process group if one is configured.

    Explicit arguments come first, then the launcher variables.  A group is
    joined when ``init_method`` is given (a world of one included) or the
    world size is above 1 (``init_method`` then defaults to ``env://``,
    which reads ``MASTER_ADDR`` and ``MASTER_PORT``).  ``device``: "cpu"
    for CPU ranks; otherwise (the default) the rank takes
    ``cuda:{local_rank % device_count}``.  Returns False for a single
    process and True once this process is a rank of a group; safe to call
    again.
    """
    global _device
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    if init_method is None and (world_size is None or world_size <= 1):
        return False
    rank = rank if rank is not None else _env_int("RANK", 0)
    local_rank = local_rank if local_rank is not None else _env_int(
        "LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "for CPU ranks")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend(dev, local_world),
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _device = dev
    return True


def is_multihost() -> bool:
    """True when this process is one rank of a group of more than one."""
    return dist.is_initialized() and dist.get_world_size() > 1


def rank_device() -> torch.device | None:
    """The device :func:`initialize_multihost` gave this rank (None
    outside a group)."""
    return _device if dist.is_initialized() else None


def global_mesh(axes: tuple[str, ...] = ("data", "graph"),
                shape: tuple[int, ...] | None = None) -> Mesh:
    """A mesh over every rank of the group.  The default two-axis layout
    puts the hosts on the leading ('data') axis and each host's ranks on
    the second, as the JAX twin does."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs a process group; call "
                           "initialize_multihost first")
    n = dist.get_world_size()
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        else:
            per = _env_int("LOCAL_WORLD_SIZE", n)
            shape = (n // per, per) if len(axes) == 2 else None
            if shape is None or shape[0] * shape[1] != n:
                raise ValueError("provide an explicit shape")
    return Mesh(axes, np.arange(n).reshape(shape), _device,
                dist.group.WORLD)


def _rank_entry(conn, rank, world, store, device, threads, fn, args):
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize_multihost(f"file://{store}", world, rank, rank, device)
        conn.send((True, fn(*args)))
    except BaseException:
        conn.send((False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def spawn_ranks(fn, world_size: int, args: tuple = (), device="cuda",
                threads: int | None = None) -> list:
    """Run ``fn(*args)`` in ``world_size`` new processes that form one
    process group, and return their results in rank order.

    ``fn`` and ``args`` must pickle (a module-level function); the
    processes start with the ``spawn`` method and import only what ``fn``
    needs.  Return numpy arrays, not tensors: torch pickles a CPU tensor
    as a handle to shared memory, which a rank that has exited no longer
    serves.  ``device``: "cuda" (rank r on card r % device_count) or "cpu"
    (gloo).  ``threads`` sets each rank's ``torch.set_num_threads``.  If a
    rank fails, the others are stopped and its traceback is raised here.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gll_ranks_")
    procs, conns = [], []
    try:
        for r in range(world_size):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_entry,
                            args=(send, r, world_size,
                                  os.path.join(tmp, "store"), device,
                                  threads, fn, args))
            p.start()
            send.close()
            procs.append(p)
            conns.append(recv)
        results = [None] * world_size
        pending = dict(enumerate(conns))
        while pending:
            for c in connection.wait(list(pending.values())):
                r = conns.index(c)
                try:
                    ok, value = c.recv()
                except EOFError:
                    procs[r].join()
                    ok, value = False, (f"rank {r} exited with code "
                                        f"{procs[r].exitcode}")
                del pending[r]
                if not ok:
                    raise RuntimeError(f"rank {r} of {world_size} failed:\n"
                                       f"{value}")
                results[r] = value
        for p in procs:
            p.join()
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        for c in conns:
            c.close()
        shutil.rmtree(tmp, ignore_errors=True)
