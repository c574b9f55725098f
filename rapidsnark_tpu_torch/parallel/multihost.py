"""Multi-process execution: one process a rank, one device a process.

Counterpart of `rapidsnark_tpu/parallel/multihost.py`. The JAX package
is single-controller: one program over a `Mesh` of every device, with
`jax.distributed` tying processes together. Here every rank runs the
same Python on its own device and calls the collectives explicitly where
`shard_map` places them; the `Mesh` below is the process group, the
rank, the world size, the rank's device and the backend.

    initialize()   joins this process to the job (RSTPU_COORD /
                   RSTPU_NPROCS / RSTPU_PROC_ID; explicit arguments win)
    global_mesh()  the Mesh of the job (a world of one without a job)
    shard_rows     a rank's contiguous slice of a host array, on the host
    replicate      a host array, whole, on the rank's device

The three collectives (`Mesh.all_gather`, a tiled `Mesh.all_to_all`,
`Mesh.broadcast`) are the only calls into torch.distributed; each
accumulates its seconds and calls in `Mesh.stats`. NCCL exchanges card
tensors. Over gloo, tensors travel through host memory: that is the
CPU tests' arrangement, and the one that runs several ranks on one card
(NCCL refuses two ranks on one card, so `initialize` raises before NCCL
is reached). The backend is always the caller's choice or the device's
default (NCCL on a card, gloo on the CPU), never a silent fall-back.
"""

from __future__ import annotations

import os
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import config, device as D


def rank_device(device, rank: int) -> torch.device:
    """The device of rank `rank`: the CPU, or a card (LOCAL_RANK when a
    launcher sets it, else rank % the cards visible); an explicit card
    index is kept. Raises without a card unless the CPU is asked for."""
    dev = D.resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else \
        rank % torch.cuda.device_count()
    return torch.device("cuda", idx)


def ranks_on_device(mesh: "Mesh") -> int:
    """The ranks of mesh's job that share its device, by rank_device's
    map over this host's ranks (LOCAL_WORLD_SIZE, else the whole job):
    every one on the CPU, rank % cards on a card."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or mesh.size)
    if mesh.device.type != "cuda":
        return local
    cards = torch.cuda.device_count()
    idx = mesh.device.index or 0
    return local // cards + (idx < local % cards)


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               init_method: Optional[str] = None) -> None:
    """Join this process to the job; a no-op for a single process with
    nothing set, as in the JAX package.

    coordinator ("host:port"), num_processes and process_id default to
    RSTPU_COORD / RSTPU_NPROCS / RSTPU_PROC_ID. `init_method` (e.g. a
    "file://" store) replaces "tcp://<coordinator>". `backend` defaults
    to "nccl" on a card and "gloo" on the CPU. NCCL needs a card a rank:
    more ranks on this host (LOCAL_WORLD_SIZE, else every rank) than
    cards raises here."""
    coordinator = coordinator or config.coordinator()
    if num_processes is None:
        num_processes = config.nprocs()
    if process_id is None:
        process_id = config.proc_id()
    if num_processes in (None, 1) and coordinator is None and \
            init_method is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process job needs num_processes and "
                         "process_id (RSTPU_NPROCS / RSTPU_PROC_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} not in "
                         f"0..{num_processes - 1}")
    dev = rank_device(device, process_id)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise RuntimeError("backend nccl needs a CUDA device")
        local = int(os.environ.get("LOCAL_WORLD_SIZE") or num_processes)
        cards = torch.cuda.device_count()
        if local > cards:
            raise RuntimeError(
                f"backend nccl needs one card a rank: {local} ranks on this "
                f"host share {cards} card(s); pass backend='gloo' to run "
                "them over host memory")
        torch.cuda.set_device(dev)
    if init_method is None:
        if coordinator is None:
            raise ValueError("a multi-process job needs a coordinator "
                             "(RSTPU_COORD host:port) or an init_method")
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the job (destroy the default process group), if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


class Mesh:
    """One rank's view of the job (torch.distributed's default process
    group): `rank` of `size` on `device`, talking over `backend` (None
    for a world of one without a process group)."""

    def __init__(self, device, rank: int = 0, size: int = 1,
                 backend: Optional[str] = None):
        self.device = torch.device(device)
        self.rank, self.size = rank, size
        self.backend = backend
        self.stats: Counter = Counter()

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend})")

    def _timed(self, name: str, fn, t: torch.Tensor) -> torch.Tensor:
        """fn(t) on the backend's side of the exchange (the rank's card
        for NCCL, host memory for gloo), back on t's device; its seconds
        (card synchronised before and after) and calls go to stats."""
        self._sync()
        t0 = time.perf_counter()
        side = self.device if self.backend == "nccl" else torch.device("cpu")
        out = fn(t.contiguous().to(side)).to(t.device)
        self._sync()
        self.stats[name + "_s"] += time.perf_counter() - t0
        self.stats[name + "_calls"] += 1
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t stacked on a new leading axis, in rank order:
        (size, *t.shape)."""
        def run(x):
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x)
            return torch.stack(parts)
        if self.backend is None:
            return t[None].clone()
        return self._timed("all_gather", run, t)

    def all_to_all(self, t: torch.Tensor, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """Tiled all-to-all (jax.lax.all_to_all(tiled=True)): t is cut
        into `size` equal parts along split_axis, part j goes to rank j,
        and the parts received are joined along concat_axis in rank
        order. Returns a contiguous tensor."""
        nd = t.dim()
        split_axis %= nd
        concat_axis %= nd
        if t.shape[split_axis] % self.size:
            raise ValueError(f"all_to_all: axis {split_axis} of "
                             f"{tuple(t.shape)} does not split {self.size} "
                             "ways")
        if self.backend is None:
            return t.contiguous()

        def run(x):
            inp = torch.stack(x.chunk(self.size, dim=split_axis))
            out = torch.empty_like(inp)
            dist.all_to_all_single(out, inp.contiguous())
            return torch.cat(out.unbind(0), dim=concat_axis)
        return self._timed("all_to_all", run, t)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s t on every rank (a new tensor)."""
        def run(x):
            x = x.clone()
            dist.broadcast(x, src)
            return x
        if self.backend is None:
            return t.clone()
        return self._timed("broadcast", run, t)


def global_mesh(device=None) -> Mesh:
    """The Mesh of this process's rank in the job that initialize()
    joined, on its device (`device` as for rank_device); without a job,
    a world of one with no process group, whose collectives are
    copies."""
    if not dist.is_initialized():
        return Mesh(rank_device(device, 0))
    rank, size = dist.get_rank(), dist.get_world_size()
    return Mesh(rank_device(device, rank), rank, size, dist.get_backend())


def _host_i32(a) -> torch.Tensor:
    """A numpy word array (uint32 / int32) or a tensor -> an int32 CPU
    tensor of the same bits."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def shard_rows(host_array, mesh: Mesh, axis: int = 0,
               length: Optional[int] = None) -> torch.Tensor:
    """This rank's contiguous 1/size slice of `host_array` along `axis`,
    an int32 tensor on the host for the caller to copy to the rank's
    device (the counterpart of put_sharded): only the slice is read, so
    a memory-mapped table never exists whole on any card. `length`
    (default the axis's size) is the padded length that is cut: the
    rows past the array's end are zeros. It must split evenly over the
    ranks."""
    n = host_array.shape[axis]
    length = n if length is None else length
    if length % mesh.size or length < n:
        raise ValueError(f"shard_rows: {length} rows (of {n}) do not "
                         f"split {mesh.size} ways")
    per = length // mesh.size
    lo = mesh.rank * per
    hi = min(lo + per, n)
    index = [slice(None)] * len(host_array.shape)
    index[axis] = slice(lo, max(lo, hi))
    part = _host_i32(host_array[tuple(index)])
    if part.shape[axis] < per:
        shape = list(part.shape)
        shape[axis] = per - part.shape[axis]
        part = torch.cat([part, torch.zeros(shape, dtype=part.dtype)],
                         dim=axis)
    return part


def replicate(host_array, mesh: Mesh) -> torch.Tensor:
    """A host array, whole, on the rank's device (every rank passes the
    same value: witness rows, tables)."""
    return _host_i32(host_array).to(mesh.device)
