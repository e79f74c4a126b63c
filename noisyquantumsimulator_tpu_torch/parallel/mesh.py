"""Process-group meshes for sweep / Monte-Carlo parallelism
(torch.distributed).

Counterpart of the reference's `parallel/mesh.py`. The reference shards its
embarrassingly-parallel axes (DE populations, sweep grids, Monte-Carlo
shots) over a jax.sharding.Mesh and lets XLA insert the reductions. Here
every rank runs the same program on its own rows of a leading axis
(`local_rows`) and the reductions are explicit collectives (`all_reduce`,
`all_gather`) on the process group.

Axis conventions, as the reference's:
  "sweep"  parameter sets (protocol/hardware points)  - pure data parallel
  "shots"  Monte-Carlo shot blocks (QEC sampling)      - pure data parallel
  "pop"    optimizer population members              - pure data parallel

A mesh spans an initialized default process group, one rank per card (NCCL)
or per CPU process (gloo). `launch` starts `world_size` local ranks over a
`file://` store in a temporary directory; `init_rank` joins one rank to
such a group (a one-rank group on the card needs no second process).
Nothing here provisions ranks or devices that were not asked for: a mesh
larger than its group raises.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist


def mesh_shape(n: int, axis_names: Sequence[str]) -> Tuple[int, ...]:
    """The reference's default factorization of n ranks over the axes: the
    largest power of two dividing n on the leading axis, the rest on the
    second, 1 on any further axis."""
    if len(axis_names) == 1:
        return (n,)
    a = 1
    while a * 2 <= n and n % (a * 2) == 0:
        a *= 2
    return (a, n // a) + (1,) * (len(axis_names) - 2)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("sweep", "shots"),
              shape: Optional[Sequence[int]] = None):
    """A DeviceMesh over the initialized default process group: "cuda" for
    an NCCL group, "cpu" for gloo. `n_devices` defaults to the group's
    size and must equal it (a mesh spans the whole group); more ranks than
    the group has raise, as the reference raises for more devices than
    exist. `shape` gives an explicit layout (its product is n_devices)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: start "
                           "the ranks with launch() or join one with init_rank()")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"make_mesh: {n} ranks requested but the process group "
                         f"has only {world}")
    if n != world:
        raise ValueError(f"make_mesh: a mesh spans its whole process group "
                         f"({world} ranks), not {n}")
    shape = tuple(shape) if shape is not None else mesh_shape(n, axis_names)
    if math.prod(shape) != n or len(shape) != len(axis_names):
        raise ValueError(f"make_mesh: shape {shape} does not lay out {n} ranks "
                         f"over the axes {tuple(axis_names)}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def local_rows(x, mesh, axis: Optional[str] = None):
    """This rank's block of the leading axis of x, split over the mesh axis
    `axis` (or over every axis, taken row-major, for None); ranks that
    differ only along other axes get the same rows. The leading length must
    divide the axes' size (see pad_to_multiple). Takes the place of the
    reference's `shard_leading`."""
    names = list(mesh.mesh_dim_names)
    axes = names if axis is None else [axis]
    size, idx = 1, 0
    for a in axes:
        dim = names.index(a)
        size *= mesh.size(dim)
        idx = idx * mesh.size(dim) + mesh.get_local_rank(dim)
    n = x.shape[0]
    if n % size:
        raise ValueError(f"local_rows: {n} rows do not split over {size} ranks "
                         f"of {tuple(axes)}; pad them first (pad_to_multiple)")
    k = n // size
    return x[idx * k:(idx + 1) * k]


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad the leading axis so it divides the mesh axis size; returns
    (padded, original_length)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, mode="edge"), n


def init_rank(rank: int, world_size: int, store_file: str,
              device: Union[str, torch.device] = "cuda") -> None:
    """Join rank `rank` of a `world_size` process group over the
    `file://` store `store_file` (a path no earlier group used): NCCL on
    cuda:rank for a CUDA device, gloo for the CPU. Raises when the card
    this rank needs does not exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() <= rank:
            raise RuntimeError(f"rank {rank} needs cuda:{rank}, but torch sees "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{store_file}",
                            world_size=world_size, rank=rank)


def _rank_main(rank, world_size, tmp, device, fn, args):
    # one thread a rank: the ranks share the host's cores (and this CPU
    # torch hangs in batched complex128 solves on two or more threads)
    torch.set_num_threads(1)
    init_rank(rank, world_size, os.path.join(tmp, "store"), device)
    try:
        out = fn(*args)
        torch.save(out, os.path.join(tmp, f"result-{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: tuple = (),
           device: Union[str, torch.device] = "cuda",
           timeout: float = 600.0) -> list:
    """Run fn(*args) on `world_size` local ranks, each a spawned process in
    a group over a `file://` store in a temporary directory (NCCL on one
    card a rank, or gloo on the CPU). `fn` must be importable by its module
    path (the ranks start from a fresh import). Returns the ranks' return
    values, by rank; a rank's exception is raised here, and ranks still
    running after `timeout` seconds are killed."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.spawn(
            _rank_main, args=(world_size, tmp, str(device), fn, args),
            nprocs=world_size, join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"launch: {world_size} ranks still running "
                                   f"after {timeout:g} s")
        return [torch.load(os.path.join(tmp, f"result-{r}.pt"),
                           weights_only=False) for r in range(world_size)]


__all__ = ["make_mesh", "mesh_shape", "local_rows", "pad_to_multiple",
           "init_rank", "launch"]
