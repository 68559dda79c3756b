"""The device mesh of the port: one rank per device in a torch.distributed
process group (counterpart of tracking_sdf_tpu.parallel.mesh, whose one
mesh axis 'd' spans every device of every process).

The grid is split into i-slabs, one per rank: with m voxels along i and n
ranks, slab = m // n and rank r owns voxel planes [r·slab, (r+1)·slab). In
the brick-major layout brick ids are row-major over (nbi, nbj, nbk), so the
same slab is the contiguous row range [r·NB/n, (r+1)·NB/n) of every leaf.

The JAX package's collectives map onto the group's:
  * ``psum`` of the normal equations and of FuseStats -> ``all_reduce``;
  * the cyclic ``ppermute`` of one halo plane (or brick layer) ->
    ``all_gather`` of every rank's first plane (each rank keeps the next
    rank's), which NCCL and Gloo both take for tensors on the rank's device;
  * the render's ``all_gather`` -> ``all_gather``;
  * ``broadcast_one_to_all`` of the realtime pacer -> ``broadcast``.

Symmetric participation: every rank issues the same collectives in the same
order, or the group deadlocks (the rule of the JAX package's multi-process
code, tracking_sdf_tpu/render/marching_cubes.py:407-411). So every rank of a
mesh runs every frame, and every rank calls what gathers: the runner's
``grid`` property, ``save_checkpoint``, ``render`` and ``export_mesh``.

Backends: NCCL when every rank has a GPU of its own; Gloo on the CPU and for
ranks that share one GPU (NCCL refuses two ranks on one device). Gloo moves
a CUDA tensor through the host; here that copy is made explicitly, so the
same calls serve both backends. A failed collective raises.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """A process group with this rank's place in it and its device.
    ``collectives`` counts the collectives issued and ``collective_s`` sums
    their host time (under NCCL the time to enqueue; under Gloo the
    exchange itself)."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    backend: str
    device: torch.device
    collectives: int = 0
    collective_s: float = 0.0

    def slab(self, m: int) -> int:
        """Planes (or rows) per rank of an axis of extent m."""
        if m % self.size:
            raise ValueError(f"grid m={m} not divisible by mesh size {self.size}")
        return m // self.size

    def rows(self, n: int) -> slice:
        """This rank's slice of an axis of extent n."""
        s = self.slab(n)
        return slice(self.rank * s, (self.rank + 1) * s)

    def i0(self, m: int) -> int:
        """Global index of this rank's first plane of an axis of extent m."""
        return self.rank * self.slab(m)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.backend == "gloo" and t.device.type != "cpu" else t

    def _timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0
        return out

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        def run():
            h = self._host(t)
            dist.all_reduce(h, group=self.group)
            if h is not t:
                t.copy_(h)
            return t
        return self._timed(run)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order, bit
        for bit (16-bit and bool tensors, which not every backend takes,
        travel as their bytes)."""
        def run():
            x = t.contiguous()
            if x.dtype in (torch.int16, torch.bfloat16, torch.bool):
                x = x.view(torch.uint8)
            h = self._host(x)
            parts = [torch.empty_like(h) for _ in range(self.size)]
            dist.all_gather(parts, h, group=self.group)
            return torch.cat(parts).to(t.device).view(t.dtype)
        return self._timed(run)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` into every rank's ``t``, in place."""
        def run():
            h = self._host(t)
            dist.broadcast(h, src=dist.get_global_rank(self.group, src)
                           if self.group is not None else src, group=self.group)
            if h is not t:
                t.copy_(h)
            return t
        return self._timed(run)

    def barrier(self) -> None:
        self._timed(lambda: dist.barrier(group=self.group))

    def next_first(self, first: torch.Tensor, fill: float) -> torch.Tensor:
        """The halo: the next rank's ``first`` (its first plane or brick
        layer), ``fill`` on the last rank (the plane past the grid)."""
        every = self.all_gather(first)
        k = first.shape[0]
        if self.rank == self.size - 1:
            return torch.full_like(first, fill)
        return every[(self.rank + 1) * k:(self.rank + 2) * k]


def default_device() -> torch.device:
    """This process's CUDA device; raises without one (ask for the CPU
    explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the mesh on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(group: Optional[dist.ProcessGroup] = None, device=None) -> Mesh:
    """The mesh of ``group`` (default the default group, which must exist):
    its size, this rank, its backend, and the rank's device (default the
    current CUDA device)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: init_group() first")
    dev = torch.device(device) if device is not None else default_device()
    return Mesh(group=group, size=dist.get_world_size(group), rank=dist.get_rank(group),
                backend=dist.get_backend(group), device=dev)


def choose_backend(device: torch.device, ranks_on_host: int) -> str:
    """NCCL when every rank on the host has a GPU of its own, else Gloo."""
    if device.type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_group(*, device, coordinator: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None,
               multihost: bool = False, timeout_s: float = 600.0) -> torch.device:
    """Create the default process group and return this rank's device.

    * ``multihost`` False: a one-rank group over this process's device, on a
      local store (no network);
    * ``coordinator`` "host:port" with ``num_processes`` and ``process_id``:
      a TCP store at the coordinator (rank 0 serves it);
    * ``multihost`` without a coordinator: the launcher's environment
      (``env://``: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), as
      jax.distributed.initialize() reads its cluster's.

    ``device`` "cuda" places rank r on GPU (local rank mod GPUs); "cpu" runs
    it on the CPU. The backend follows ``choose_backend``."""
    from datetime import timedelta

    dev = torch.device(device)
    timeout = timedelta(seconds=timeout_s)
    if not multihost:
        world, rank, local_world, local_rank = 1, 0, 1, 0
    elif coordinator:
        # the JAX package's jax.distributed.initialize raises the same
        if num_processes is None:
            raise ValueError("Number of processes must be defined.")
        if process_id is None:
            raise ValueError("The process id of the current process must be defined.")
        world, rank = num_processes, process_id
        # the coordinator's processes are this host's unless a launcher says
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    else:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError("coordinator_address should be defined.")
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_world)
    kw = dict(backend=backend, timeout=timeout, world_size=world, rank=rank)
    if backend == "nccl":
        kw["device_id"] = dev
    if not multihost:
        dist.init_process_group(store=dist.HashStore(), **kw)
    elif coordinator:
        dist.init_process_group(init_method=f"tcp://{coordinator}", **kw)
    else:
        dist.init_process_group(init_method="env://", **kw)
    return dev


def shard_grid(grid, mesh: Mesh):
    """This rank's i-slab of a dense grid (TSDFGrid of (m, m, m) tensors, or
    a mapping of numpy leaves such as a JAX grid's ``_asdict()``), as a
    TSDFGrid of copies on the mesh's device."""
    from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid, grid_from_numpy

    if isinstance(grid, TSDFGrid):
        sl = mesh.rows(grid.D.shape[0])
        return TSDFGrid(*(getattr(grid, k)[sl].to(mesh.device, copy=True).contiguous()
                          for k in FIELDS))
    return grid_from_numpy(grid, device=mesh.device, mesh=mesh)


def shard_brick_grid(bgrid, mesh: Mesh):
    """This rank's rows of a BrickGrid (or of a mapping of its numpy leaves,
    such as a JAX BrickGrid's ``_asdict()``): an equal split of the rows is
    exactly an i-slab of bricks."""
    from tracking_sdf_tpu_torch.fusion.brickmajor import BrickGrid, brick_grid_from_numpy

    if isinstance(bgrid, BrickGrid):
        sl = mesh.rows(bgrid.D.shape[0])
        return BrickGrid(*(x[sl].to(mesh.device, copy=True).contiguous()
                           for x in (bgrid.D, bgrid.W, bgrid.C)))
    return brick_grid_from_numpy(bgrid, device=mesh.device, mesh=mesh)


def gather_grid(grid, mesh: Mesh):
    """The whole dense grid from every rank's slab (a collective: every rank
    calls it), on every rank. One all_gather of the six leaves stacked."""
    from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid

    every = mesh.all_gather(torch.stack([getattr(grid, k) for k in FIELDS], dim=1))
    return TSDFGrid(*(every[:, c].contiguous() for c in range(len(FIELDS))))


def gather_brick_grid(bgrid, mesh: Mesh):
    """The whole BrickGrid from every rank's rows (a collective), on every
    rank: the D, W and C rows gathered as their 16-bit lanes, bit for bit."""
    from tracking_sdf_tpu_torch.fusion.brickmajor import BrickGrid

    D, W, C = bgrid.D, bgrid.W, bgrid.C
    lanes = torch.cat([D.contiguous().view(torch.int16), W.contiguous().view(torch.int16),
                       C], dim=1)
    every = mesh.all_gather(lanes)
    d, w = D.shape[1] * D.element_size() // 2, W.shape[1] * W.element_size() // 2
    return BrickGrid(every[:, :d].contiguous().view(D.dtype),
                     every[:, d:d + w].contiguous().view(W.dtype),
                     every[:, d + w:].contiguous())

