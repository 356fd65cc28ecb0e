"""The host mesh (``repro.launch.mesh`` counterpart).

A function, not a module-level constant: importing this module starts no
process group and touches no device.

Axis semantics:
  data  -- the batch / data-parallel axis: the batch split over its ranks,
           and the parameters FSDP-sharded over it where the rule tables
           say so (``dist.sharding``)
  model -- the tensor / expert / vocab-parallel axis

The reference builds its meshes from the devices one controller sees
(``jax.make_mesh``); the port runs one process per rank
(``dist.run_ranks``), so a mesh is one rank's view: its place on each axis
and, for each axis, the ``PartitionMesh`` whose collectives span the ranks
that share this rank's index on the other.  ``make_mesh(data=D, model=T)``
is ``jax.make_mesh((D, T), ("data", "model"))``: rank ``r`` sits at ``(r //
T, r % T)``, the model index fastest, as ``jax.make_mesh`` orders devices.
``make_host_mesh()`` is ``(D, 1)`` over every rank, as the reference's is.
The reference's 256/512-chip ``make_production_mesh`` has no counterpart
here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import PartitionMesh, partition_mesh

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class HostMesh:
    """One rank's view of a ``(data = D, model = T)`` mesh over ``AXES``:
    ``data`` is the ``PartitionMesh`` of the D ranks that share this rank's
    model index, ``model`` that of the T ranks that share its data index
    (each counts its own collectives in its ``stats``); a one-rank axis is a
    ``PartitionMesh`` of one rank, whose collectives are no calls."""

    data: PartitionMesh
    model: PartitionMesh | None = None
    axis_names: tuple = AXES

    def __post_init__(self):
        if self.model is None:
            object.__setattr__(self, "model",
                               PartitionMesh(1, 0, self.data.device, None))

    @property
    def shape(self) -> dict:
        """Axis name -> its size."""
        return {"data": self.data.world_size, "model": self.model.world_size}

    @property
    def size(self) -> int:
        return self.data.world_size * self.model.world_size

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def rank(self) -> int:
        """This rank's place in the process group: ``data index * T + model
        index``."""
        return self.data.rank * self.model.world_size + self.model.rank

    def barrier(self) -> None:
        """Every rank of the mesh waits here until all have arrived."""
        if self.size > 1:
            dist.barrier()

    def stats(self) -> dict:
        """Both axes' collective stats (``CollectiveStats.snapshot``)."""
        return {"data": self.data.stats.snapshot(), "model": self.model.stats.snapshot()}


def make_host_mesh(*, device=None) -> HostMesh:
    """Whatever ranks run this program, as a ``(data, model)`` mesh with
    ``model = 1``: every rank of the process group ``dist.run_ranks``
    started, or, outside one, a one-rank mesh.  The rank computes on
    ``device`` (by default the card ``run_ranks`` gave it, or the card;
    ``device="cpu"`` where there is none)."""
    return HostMesh(partition_mesh(device=device))


def make_mesh(*, data: int, model: int, device=None) -> HostMesh:
    """A ``(data = D, model = T)`` mesh over the ``D * T`` ranks of the
    process group (``jax.make_mesh((D, T), ("data", "model"))``): rank ``r``
    at ``(r // T, r % T)``.  Inside a group every rank must call it at once
    (each axis's groups are made by ``dist.new_group``, every group by every
    rank, in one order); outside one only ``(1, 1)`` exists."""
    d, t = int(data), int(model)
    world = partition_mesh(device=device)
    if d * t != world.world_size:
        raise ValueError(f"a ({d}, {t}) mesh needs {d * t} ranks; the process group has "
                         f"{world.world_size}")
    if t == 1:
        return HostMesh(world)
    if d == 1:
        return HostMesh(PartitionMesh(1, 0, world.device, None), world)
    i, j = divmod(world.rank, t)
    model_groups = [dist.new_group([a * t + b for b in range(t)]) for a in range(d)]
    data_groups = [dist.new_group([a * t + b for a in range(d)]) for b in range(t)]
    return HostMesh(
        PartitionMesh(d, i, world.device, world.backend, group=data_groups[j]),
        PartitionMesh(t, j, world.device, world.backend, group=model_groups[i]),
    )
