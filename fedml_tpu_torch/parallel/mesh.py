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

Hierarchical FL's 2-D ``('group', 'clients')`` mesh
(:func:`hierarchical_mesh`) lays the ranks out row-major: rank r sits in
group row ``r // clients_per_group`` at slot ``r % clients_per_group``, and
each axis is a subgroup of the process group (a row's ranks for the
``clients`` all-reduce, a column's for the ``group`` one).

The LM axes and the data-parallel batch axis take a :class:`NamedMesh`
(:func:`named_mesh`): any axis names and sizes, ranks row-major as
``np.reshape(devices, sizes)`` lays them out, and a subgroup for every line
of every set of axes, which every rank creates in the same order. A step
binds the mesh's names for its forward and backward (:class:`bound_axes`),
as ``shard_map`` binds them, and a module built with an axis name finds its
line with :func:`axis_line`.
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


@dataclass(frozen=True)
class HierarchicalMesh:
    """One rank's view of the 2-D ``('group', 'clients')`` mesh:
    ``num_groups`` rows of ``clients_per_group`` ranks, this rank at
    (``group_index``, ``slot``). ``clients`` is the :class:`ClientMesh` of
    this rank's row (the group all-reduce), ``groups`` that of its column
    (the global reduce across groups); an axis of one rank has no group."""

    world_size: int
    rank: int
    group: Optional[dist.ProcessGroup]
    device: torch.device
    num_groups: int
    clients_per_group: int
    clients: ClientMesh
    groups: ClientMesh

    @property
    def shape(self) -> dict:
        """The JAX mesh's axis sizes."""
        return {"group": self.num_groups, "clients": self.clients_per_group}

    @property
    def group_index(self) -> int:
        return self.rank // self.clients_per_group

    @property
    def slot(self) -> int:
        return self.rank % self.clients_per_group


def hierarchical_mesh(num_groups: int, clients_per_group: int,
                      device: Optional[Union[str, torch.device]] = None) -> HierarchicalMesh:
    """The ``('group', 'clients')`` mesh over the initialised process group
    (``num_groups * clients_per_group`` must be its world size), or, without
    one, the one-rank mesh ``G = 1`` with no group. Every rank builds the
    same subgroups in the same order (``dist.new_group`` is collective):
    one a row, then one a column, skipping axes of one rank."""
    base = client_mesh(device=device)
    G, cpg = int(num_groups), int(clients_per_group)
    if G * cpg != base.world_size:
        raise ValueError(f"a {G} x {cpg} ('group', 'clients') mesh needs {G * cpg} ranks; the "
                         f"process group has {base.world_size}")
    g, s = divmod(base.rank, cpg)
    rows = [dist.new_group([r * cpg + j for j in range(cpg)]) if cpg > 1 else None
            for r in range(G)]
    cols = [dist.new_group([r * cpg + j for r in range(G)]) if G > 1 else None
            for j in range(cpg)]
    return HierarchicalMesh(base.world_size, base.rank, base.group, base.device, G, cpg,
                            ClientMesh(cpg, s, rows[g], base.device),
                            ClientMesh(G, g, cols[s], base.device))


# -- named meshes (the LM axes and the data-parallel batch axis) ---------------------------


@dataclass(frozen=True)
class AxisLine:
    """One rank's line of ranks along some axes of a :class:`NamedMesh`:
    ``size`` ranks (global ``ranks``, in row-major order of those axes),
    this rank at ``index``, and the process group the collectives over the
    line take (None where there is none: a line of one rank that is not the
    whole world, or no process group at all). The collective of a line
    without a group is the identity."""

    size: int
    index: int
    ranks: tuple
    group: Optional[dist.ProcessGroup]


@dataclass(frozen=True, eq=False)
class NamedMesh:
    """One rank's view of an n-D mesh of named axes over the process group
    (the JAX package's ``Mesh(np.reshape(devices, sizes), names)``): rank r
    sits at ``np.unravel_index(r, sizes)``, row-major, and ``line(*axes)``
    is its :class:`AxisLine` along any set of the axes."""

    axis_names: tuple
    sizes: tuple
    rank: int
    world_size: int
    device: torch.device
    lines: dict

    @property
    def shape(self) -> dict:
        """The JAX mesh's axis sizes."""
        return dict(zip(self.axis_names, self.sizes))

    def coord(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self.line(axis).index

    def line(self, *axes: str) -> AxisLine:
        """This rank's line along ``axes`` (any order; unknown names raise)."""
        bad = [a for a in axes if a not in self.axis_names]
        if bad or not axes:
            raise ValueError(f"axes {axes} are not all axes of the mesh {self.axis_names}")
        return self.lines[tuple(a for a in self.axis_names if a in axes)]

    def block(self, n: int, axis: str) -> slice:
        """This rank's block of ``n`` items split over ``axis``."""
        ln = self.line(axis)
        if n % ln.size:
            raise ValueError(f"{n} does not split over the {ln.size} ranks of axis {axis!r}")
        per = n // ln.size
        return slice(ln.index * per, (ln.index + 1) * per)


def named_mesh(axis_names: Sequence[str], sizes: Sequence[int],
               device: Optional[Union[str, torch.device]] = None) -> NamedMesh:
    """The mesh of named axes over the initialised process group, whose
    world size must be the product of ``sizes``; without a group, a mesh of
    one rank (every size 1). Every rank creates the subgroup of every line
    of every set of axes, in the same order (``dist.new_group`` is
    collective): a line of all ranks takes the world group, and a line of
    one rank takes none."""
    import itertools

    base = client_mesh(device=device)
    names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
    need = int(np.prod(sizes))
    if need != base.world_size:
        raise ValueError(f"a {dict(zip(names, sizes))} mesh needs {need} ranks; the process "
                         f"group has {base.world_size} (start it with init_multihost)")
    grid = np.arange(need).reshape(sizes)
    lines = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(range(len(names)), k):
            rest = [d for d in range(len(names)) if d not in axes]
            flat = grid.transpose(rest + list(axes)).reshape(-1, int(np.prod([sizes[d] for d in axes])))
            for row in flat:
                ranks = tuple(int(r) for r in row)
                if base.group is None:
                    group = None
                elif len(ranks) == base.world_size:
                    group = base.group
                else:
                    group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
                if base.rank in ranks:
                    lines[tuple(names[d] for d in axes)] = AxisLine(
                        len(ranks), ranks.index(base.rank), ranks, group)
    return NamedMesh(names, sizes, base.rank, base.world_size, base.device, lines)


#: the meshes whose axis names the running step binds (innermost last);
#: process-wide, so a backward on autograd's device threads sees them too
_BOUND: list = []


class bound_axes:
    """``with bound_axes(mesh):`` binds the mesh's axis names for the code
    inside, as ``shard_map`` binds them for its body: modules built with an
    axis name (``ring_axis``, ``bn_axis``, a tensor- or expert-parallel
    axis) find their :class:`AxisLine` through :func:`axis_line`."""

    def __init__(self, mesh: NamedMesh):
        self.mesh = mesh

    def __enter__(self):
        _BOUND.append(self.mesh)
        return self.mesh

    def __exit__(self, *_exc):
        _BOUND.pop()


def axis_line(*axes: str) -> AxisLine:
    """This rank's line along ``axes`` of the innermost bound mesh that has
    them; an unbound name raises ``ValueError`` (JAX's unbound axis name)."""
    for mesh in reversed(_BOUND):
        if all(a in mesh.axis_names for a in axes):
            return mesh.line(*axes)
    raise ValueError(f"unbound axis name(s) {axes}: run inside a step over a mesh with them "
                     "(parallel/mesh.bound_axes)")
