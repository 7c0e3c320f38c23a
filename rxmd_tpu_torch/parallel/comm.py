"""The collectives of the sharded engine on torch.distributed: one process
per spatial domain (the counterpart of the jax.lax collectives that
rxmd_tpu.parallel.engine calls inside shard_map).

  * `psum` / `pmax`: `dist.all_reduce` with SUM / MAX.  Ring and tree
    all-reduces finish every element on one rank and copy it to the
    others, so every rank holds the same bits and takes the same host-side
    branches (CG stop, rebuild trigger, overflow traps);
  * `shift(x, axis, d)`: the `ppermute` along one mesh axis, each rank
    sending to its face neighbor at +d and receiving from the one at -d;
  * `all_gather`: fixed-size blocks from every rank, in rank order.

Inside a CUDA graph (graphs.GraphCache runs the sharded engine's programs
on its side stream) the collectives are captured with the kernels around
them.  Each runs on the caller's current stream, the cache's side stream
while it captures and at a program's eager first use alike:
ProcessGroupNCCL orders its NCCL stream after the current stream and the
current stream after it, events a capture records as graph edges.  A
wait (`all_reduce`'s own, `Work.wait` in `shift`) is such an event wait
on the stream and never blocks the host (no blocking-wait setting is
made).  NCCL creates a communicator at its first collective, which a
capture cannot hold (it allocates and synchronizes): the eager first use
of every program's key runs each collective the program holds before it
is captured.

Rank r is the mesh block d = (ix*ny + iy)*nz + iz, z fastest, as rxmd_tpu
numbers its device blocks (rxmd_tpu/io/slab.py:136-137), so `distribute`
and the slab writers agree across packages.  The process group comes from
RXMD_COORDINATOR (host:port), RXMD_NUM_PROCESSES and RXMD_PROCESS_ID, the
variables rxmd_tpu's multi-host launch reads (rxmd_tpu/__main__.py:21-29).
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils import timers as trace

ENV_COORDINATOR = "RXMD_COORDINATOR"
ENV_NUM_PROCESSES = "RXMD_NUM_PROCESSES"
ENV_PROCESS_ID = "RXMD_PROCESS_ID"


def device_for_rank(rank: int, device="cuda") -> torch.device:
    """The rank's device: card `rank % device_count` for "cuda", the CPU
    only where the caller asks for it."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("sharded engine on 'cuda': no CUDA device")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_process_group(rank: int, world_size: int, coordinator: str,
                       device="cuda", timeout_s: float = 600.0):
    """Join the process group at tcp://`coordinator`: NCCL for "cuda" (the
    rank's card becomes the current device), gloo only for an explicit
    "cpu".  Returns the rank's device."""
    dev = device_for_rank(rank, device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def init_from_env(device="cuda"):
    """The process group of a launch through the RXMD_* variables, or None
    when RXMD_COORDINATOR is unset (a single process).  Returns the rank's
    device or None."""
    coord = os.environ.get(ENV_COORDINATOR)
    if not coord:
        return None
    missing = [k for k in (ENV_NUM_PROCESSES, ENV_PROCESS_ID)
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"{ENV_COORDINATOR} is set but {missing} not: "
                           "each process needs RXMD_NUM_PROCESSES=N and "
                           "RXMD_PROCESS_ID=0..N-1")
    return init_process_group(int(os.environ[ENV_PROCESS_ID]),
                              int(os.environ[ENV_NUM_PROCESSES]), coord,
                              device)


def destroy():
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world():
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def block_coords(d, mesh_shape):
    """Mesh coordinates (ix, iy, iz) of block / rank d (z fastest)."""
    _, ny, nz = mesh_shape
    return d // (ny * nz), (d // nz) % ny, d % nz


def block_index(coords, mesh_shape):
    _, ny, nz = mesh_shape
    ix, iy, iz = coords
    return (ix * ny + iy) * nz + iz


class Comm:
    """This rank's place in the mesh and its collectives.  In a process
    group every reduction and gather goes through it, one rank's included
    (NCCL or gloo then runs them); without one the mesh must be one block
    and they are the identity, as on a one-device mesh."""

    def __init__(self, mesh_shape):
        self.mesh_shape = tuple(int(k) for k in mesh_shape)
        self.rank, self.size = world()
        self.grouped = dist.is_available() and dist.is_initialized()
        ndom = int(np.prod(self.mesh_shape))
        if ndom != self.size:
            raise RuntimeError(
                f"mesh {self.mesh_shape} has {ndom} domains but "
                f"{self.size} process(es) run: the sharded engine runs one "
                f"process per domain; launch {ndom} processes with "
                f"{ENV_COORDINATOR}=host:port {ENV_NUM_PROCESSES}={ndom} "
                f"{ENV_PROCESS_ID}=0..{ndom - 1}")
        self.coords = block_coords(self.rank, self.mesh_shape)

    def neighbor(self, axis: int, d: int) -> int:
        """Rank of the face neighbor at offset d along `axis` (periodic)."""
        c = list(self.coords)
        c[axis] = (c[axis] + d) % self.mesh_shape[axis]
        return block_index(c, self.mesh_shape)

    def psum(self, x):
        """Sum of x over all ranks (bitwise equal on every rank)."""
        if not self.grouped:
            return x
        with trace.phase("allreduce"):
            x = x.clone()
            dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    def pmax(self, x):
        if not self.grouped:
            return x
        with trace.phase("allreduce"):
            x = x.clone()
            dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return x

    def all_gather(self, x):
        """(size, *x.shape): every rank's x, in rank order."""
        if not self.grouped:
            return x[None]
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x.contiguous())
        return torch.stack(out)

    def shift(self, x, axis: int, d: int):
        """The ppermute along `axis`: send x to the neighbor at +d, return
        what the neighbor at -d sent.  On an axis of one domain that is x
        itself (a periodic self-image); on an axis of two both neighbors
        are one rank, and the single send and receive of the call pair
        up by their tag."""
        n = self.mesh_shape[axis]
        if n == 1:
            return x
        dst = self.neighbor(axis, d)
        src = self.neighbor(axis, -d)
        tag = 2 * axis + (d > 0)
        out = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(), dst, tag=tag),
            dist.P2POp(dist.irecv, out, src, tag=tag)])
        for r in reqs:
            r.wait()
        return out

    def barrier(self):
        if self.grouped:
            dist.barrier()
