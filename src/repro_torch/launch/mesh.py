"""The host mesh (``repro.launch.mesh`` counterpart).

A function, not a module-level constant: importing this module starts no
process group and touches no device.

Axis semantics:
  data  -- the batch / data-parallel axis: one rank each, the batch split
           over them, the parameters replicated
  model -- the tensor / expert-parallel axis (1 on the host mesh)

The reference builds its meshes from the devices one controller sees
(``jax.make_mesh``); the port runs one process per rank
(``dist.run_ranks``), so a mesh is one rank's view: its place on each axis
and the ``PartitionMesh`` whose collectives span the ranks along ``data``.
The reference's 256/512-chip ``make_production_mesh`` has no counterpart
here.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.sharding import PartitionMesh, partition_mesh

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class HostMesh:
    """One rank's view of a ``(data = D, model = 1)`` mesh over ``AXES``:
    ``data`` is the ``PartitionMesh`` of every rank of the process group
    (its collectives, counted in its ``stats``, run along the data axis)."""

    data: PartitionMesh
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict:
        """Axis name -> its size."""
        return {"data": self.data.world_size, "model": 1}

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def rank(self) -> int:
        """This rank's index along ``data``."""
        return self.data.rank


def make_host_mesh(*, device=None) -> HostMesh:
    """Whatever ranks run this program, as a ``(data, model)`` mesh with
    ``model = 1``: every rank of the process group ``dist.run_ranks``
    started, or, outside one, a one-rank mesh.  The rank computes on
    ``device`` (by default the card ``run_ranks`` gave it, or the card;
    ``device="cpu"`` where there is none)."""
    return HostMesh(partition_mesh(device=device))
