"""Process meshes on torch.distributed (the torch counterpart of the JAX
parallel/sharding.py make_mesh over local devices).

JAX gets its devices from XLA and lays them out as a named mesh.  Torch gets
its ranks from processes, so this module has two parts:

  * spawn(fn, world_size, backend, device, *args) starts `world_size`
    processes sharing a torch.distributed.FileStore in a temporary directory
    (so concurrent runs never collide on ports), runs `fn(device, *args)` in
    each and returns rank 0's result.  `fn` is a module-level function of
    this package (the children import torch and the port only).
  * make_mesh({"rays": 2, "gauss": 2}) lays the ranks out row-major, first
    axis slowest, as a JAX Mesh of devices reshaped to that shape, and
    builds each axis's process groups with dist.new_group: every rank
    creates every group, in the same order.

The backend is the caller's choice, and nothing switches it:

  * "gloo" for CPU ranks and for ranks that share one card.  Its CUDA
    tensors are staged through the host here, explicitly, by every
    collective of this module; the compute stays on the card.  Ranks on one
    card budget their launches on their share of it (device.share_card).
  * "nccl" for one card per rank (rank r on cuda:r).  spawn raises if NCCL
    is asked for more ranks than there are visible cards: NCCL refuses two
    ranks on one device.

The collectives record their calls, bytes and host time in STATS (the
parallel modes' layer metrics; reset_stats() clears them).
"""

from __future__ import annotations

import itertools
import math
import os
import tempfile
import time
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device, share_card

BACKENDS = ("gloo", "nccl")

# per collective: calls, bytes each rank sends, host ms (a rank's clock,
# around the call and its staging)
STATS: dict[str, dict] = {}


def reset_stats() -> None:
    STATS.clear()


def _record(name: str, nbytes: int, t0: float) -> None:
    s = STATS.setdefault(name, dict(calls=0, bytes=0, ms=0.0))
    s["calls"] += 1
    s["bytes"] += nbytes
    s["ms"] += (time.perf_counter() - t0) * 1e3


class Mesh(NamedTuple):
    """A named layout of the ranks: per axis its size, this rank's index
    along it and the process group of the ranks that differ from this one
    only along it."""

    shape: dict          # axis -> size, in layout order
    index: dict          # axis -> this rank's coordinate
    groups: dict         # axis -> dist.ProcessGroup
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(shape: dict, device: torch.device | str) -> Mesh:
    """The mesh of `shape` (axis -> size, the product the world size) over
    the initialised process group, for the rank's tensors on `device`."""
    world, rank = dist.get_world_size(), dist.get_rank()
    axes, sizes = list(shape), [int(v) for v in shape.values()]
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(sizes)} ranks, the "
                         f"process group has {world}")
    coords, r = [], rank
    for n in reversed(sizes):
        coords.append(r % n)
        r //= n
    coords.reverse()
    strides = [math.prod(sizes[k + 1:]) for k in range(len(sizes))]
    groups = {}
    for k, axis in enumerate(axes):
        # every line of ranks along `axis`, in rank order of the others
        others = [j for j in range(len(sizes)) if j != k]
        for rest in itertools.product(*(range(sizes[j]) for j in others)):
            base = sum(c * strides[j] for c, j in zip(rest, others))
            ranks = [base + i * strides[k] for i in range(sizes[k])]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(shape=dict(zip(axes, sizes)), index=dict(zip(axes, coords)),
                groups=groups, device=torch.device(device))


def _staged(t: torch.Tensor, group) -> tuple[torch.Tensor, bool]:
    """(the tensor the backend takes, whether it is a host copy)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu(), True
    return t.contiguous(), False


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of `t` over the ranks along `axis` (a new tensor on t's
    device)."""
    t0 = time.perf_counter()
    group = mesh.groups[axis]
    buf, host = _staged(t.clone(), group)
    dist.all_reduce(buf, group=group)
    out = buf.to(t.device) if host else buf
    _record("all_reduce", t.numel() * t.element_size(), t0)
    return out


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The ranks' `t` along `axis`, concatenated along `dim` in axis
    order."""
    t0 = time.perf_counter()
    group = mesh.groups[axis]
    buf, host = _staged(t, group)
    parts = [torch.empty_like(buf) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts, dim=dim)
    if host:
        out = out.to(t.device)
    _record("all_gather", t.numel() * t.element_size(), t0)
    return out


def rank_device(backend: str, device: torch.device, rank: int
                ) -> torch.device:
    """The device of `rank`: cuda:rank under NCCL; under gloo `device`
    (cuda: the card of its index, 0 by default, which the ranks share)."""
    if device.type != "cuda":
        return device
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def _rank_main(rank: int, world_size: int, backend: str, device: str,
               store_path: str, result_path: str, fn, args) -> None:
    device = torch.device(device)
    dev = rank_device(backend, device, rank)
    if dev.type == "cpu":
        # one thread per rank, so several ranks do not oversubscribe cores
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
        share_card(world_size if backend == "gloo" else 1)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    try:
        out = fn(dev, *args)
        if rank == 0:
            torch.save(out, result_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str, device: torch.device | str,
          *args):
    """Run fn(device, *args) in `world_size` new processes joined in one
    process group of `backend`, and return rank 0's result (saved with
    torch.save, so it should hold CPU tensors).  A rank that raises fails
    the call, with its traceback, and the others are stopped.  Arguments go
    to the children by pickling: pass CPU tensors or arrays."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    device = resolve_device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("backend 'nccl' needs device 'cuda' (one card "
                             "per rank); use 'gloo' for CPU ranks")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"backend 'nccl' with {world_size} ranks needs {world_size} "
                f"cards, {cards} visible: NCCL refuses two ranks on one "
                "device; use 'gloo' to share a card")
    with tempfile.TemporaryDirectory(prefix="egr_spawn_") as tmp:
        store_path = os.path.join(tmp, "store")
        result_path = os.path.join(tmp, "result.pt")
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(world_size, backend, str(device), store_path,
                       result_path, fn, args))
        return torch.load(result_path, weights_only=False)
