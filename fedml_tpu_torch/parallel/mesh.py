"""The client mesh over ``torch.distributed`` (counterpart of
``fedml_tpu/parallel/mesh.py``).

The JAX package shards clients along a ``'clients'`` axis of a device
``Mesh`` and aggregates with ``psum`` inside ``shard_map``. Here the mesh is
the process group: one rank a card, each rank holding a contiguous block of
the stacked client arrays (``[rank*L:(rank+1)*L]``), and the aggregation
one SUM all-reduce (``parallel/crosssilo.all_reduce_flat``). Every process
holds the full host dataset, as the JAX package's ``global_put`` assumes in
a multi-process run. Placement is explicit: :func:`shard_client_batch`
moves a rank's block to its device, and nothing is replicated by a
sharding; ``replicated``, ``client_sharded`` and ``global_put`` have no
counterpart.

Without an initialised process group the mesh has one rank and no group,
and the all-reduce is the identity (as ``psum`` over one device is).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from fedml_tpu_torch import default_device


@dataclass(frozen=True)
class ClientMesh:
    """One rank's view of the client mesh: ``world_size`` ranks, this
    process's ``rank``, the process group (None without one) and the
    device the rank trains on."""

    world_size: int
    rank: int
    group: Optional[dist.ProcessGroup]
    device: torch.device

    @property
    def shape(self) -> dict:
        """The JAX mesh's axis sizes: ``{"clients": world_size}``."""
        return {"clients": self.world_size}

    def block(self, n: int) -> slice:
        """This rank's rows of an axis of ``n`` stacked clients (``n`` a
        multiple of the world size)."""
        if n % self.world_size:
            raise ValueError(f"{n} clients do not split over {self.world_size} ranks")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)


def client_mesh(n_devices: Optional[int] = None,
                device: Optional[Union[str, torch.device]] = None) -> ClientMesh:
    """The mesh of the initialised process group (its world size and this
    rank; the device ``cuda:LOCAL_RANK``, or ``cuda:rank % cards`` without
    ``LOCAL_RANK``, unless ``device`` asks for the CPU), or a one-rank mesh
    without a group on ``default_device(device)``. ``n_devices`` other than
    the world size raises."""
    if dist.is_available() and dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the mesh has {world} rank(s): start "
                         "the process group with that world size (init_multihost)")
    dev = default_device(device)
    if group is not None and dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else rank % torch.cuda.device_count())
    return ClientMesh(world, rank, group, dev)


def init_multihost(coordinator_address: str, num_processes: int, process_id: int,
                   device: Optional[Union[str, torch.device]] = None,
                   timeout_s: float = 300.0) -> int:
    """Join a multi-process run: ``torch.distributed.init_process_group``
    over NCCL when the ranks train on CUDA, gloo on the CPU, at
    ``coordinator_address`` (``tcp://host:port`` or ``file:///path``).
    Returns this process's rank. A second call is a no-op."""
    if not dist.is_initialized():
        backend = "nccl" if default_device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=coordinator_address,
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def shard_client_batch(mesh: ClientMesh, arrays: Sequence[np.ndarray],
                       dtype: Optional[torch.dtype] = None) -> tuple:
    """This rank's block of each stacked per-client host array, on the
    mesh's device; ``dtype`` casts the floating ones (the training compute
    dtype)."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)[mesh.block(len(a))]))
        t = t.to(mesh.device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out.append(t)
    return tuple(out)
