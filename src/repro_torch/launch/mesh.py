"""The host mesh (``repro.launch.mesh`` counterpart).

A function, not a module-level constant: importing this module starts no
process group and touches no device.

Axis semantics (the reference's):
  pod   -- across-pod data parallelism (the parameters replicated per pod)
  data  -- the in-pod batch / data-parallel axis: the batch split over its
           ranks, and the parameters FSDP-sharded over it where the rule
           tables say so (``dist.sharding``)
  model -- the tensor / expert / vocab-parallel axis

The reference builds its meshes from the devices one controller sees
(``jax.make_mesh``); the port runs one process per rank
(``dist.run_ranks``), so a mesh is one rank's view: its place on each axis
and, for each axis, the ``PartitionMesh`` whose collectives span the ranks
that share this rank's index on the others.  ``make_mesh(pod=P, data=D,
model=T)`` is ``jax.make_mesh((P, D, T), ("pod", "data", "model"))``: rank
``r`` sits at ``(r // (D*T), (r // T) % D, r % T)``, the model index
fastest, as ``jax.make_mesh`` orders devices.  The batch axes are ``("pod",
"data")``: ``HostMesh.batch`` spans the P*D ranks that share this rank's
model index, pod-major (the order of ``P(("pod", "data"))``).
The flattened axis ``("pod", "data", "model")`` (``HostMesh.flat``) spans
all P*D*T ranks in rank order: the GNN steps shard their graph arrays over
it, as the reference's ``dp + ("model",)`` does (``launch.steps``); with
the model index fastest its index is the rank itself.
``make_host_mesh()`` is ``(D, 1)`` over every rank, as the reference's is.
``make_production_mesh`` is the reference's 256/512-chip layout as sizes
alone (``MeshLayout``): no process group, for the dry run's reckoning
(``launch.dryrun``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import PartitionMesh, partition_mesh

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def _one_rank(device) -> PartitionMesh:
    return PartitionMesh(1, 0, device, None)


@dataclasses.dataclass(frozen=True, eq=False)
class HostMesh:
    """One rank's view of a ``(pod = P, data = D, model = T)`` mesh:
    ``data`` is the ``PartitionMesh`` of the D ranks that share this rank's
    pod and model indices, ``model`` that of the T ranks that share its pod
    and data indices, ``pod`` that of the P ranks that share its data and
    model indices, and ``batch`` that of the P*D ranks that share its model
    index (the batch axes ``("pod", "data")``; ``data`` itself where P = 1),
    and ``flat`` that of all P*D*T ranks in rank order (the flattened axis
    ``("pod", "data", "model")`` the GNN steps shard their graphs over).
    Each counts its own collectives in its ``stats``; a one-rank axis is a
    ``PartitionMesh`` of one rank, whose collectives are no calls.  ``shape``
    and ``axis_names`` name ``pod`` only where P > 1."""

    data: PartitionMesh
    model: PartitionMesh | None = None
    pod: PartitionMesh | None = None
    batch: PartitionMesh | None = None
    flat: PartitionMesh | None = None

    def __post_init__(self):
        if self.model is None:
            object.__setattr__(self, "model", _one_rank(self.data.device))
        if self.pod is None:
            object.__setattr__(self, "pod", _one_rank(self.data.device))
        if self.batch is None:
            if self.pod.world_size > 1:
                raise ValueError("a mesh with a pod axis needs its batch axis")
            object.__setattr__(self, "batch", self.data)
        if self.flat is None:
            if self.size != self.data.world_size:
                raise ValueError("a mesh with a model or pod axis needs its flat axis")
            d = self.data  # the data axis is every rank: its group, counted apart
            object.__setattr__(self, "flat", PartitionMesh(d.world_size, d.rank, d.device,
                                                           d.backend, group=d.group))

    @property
    def axis_names(self) -> tuple:
        return POD_AXES if self.pod.world_size > 1 else AXES

    @property
    def shape(self) -> dict:
        """Axis name -> its size."""
        out = {"data": self.data.world_size, "model": self.model.world_size}
        return {"pod": self.pod.world_size, **out} if self.pod.world_size > 1 else out

    @property
    def size(self) -> int:
        return self.pod.world_size * self.data.world_size * self.model.world_size

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def rank(self) -> int:
        """This rank's place in the process group: ``(pod index * D + data
        index) * T + model index``."""
        return self.batch.rank * self.model.world_size + self.model.rank

    def barrier(self) -> None:
        """Every rank of the mesh waits here until all have arrived."""
        if self.size > 1:
            dist.barrier()

    def stats(self) -> dict:
        """Each axis's collective stats (``CollectiveStats.snapshot``):
        ``data``, ``model`` and ``flat``, and where P > 1 also ``pod`` and
        ``batch`` (the pod x data group)."""
        out = {"data": self.data.stats.snapshot(), "model": self.model.stats.snapshot(),
               "flat": self.flat.stats.snapshot()}
        if self.pod.world_size > 1:
            out["pod"] = self.pod.stats.snapshot()
            out["batch"] = self.batch.stats.snapshot()
        return out


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axes and sizes with no process group behind them (the
    reference's production meshes, for reckoning): what
    ``dist.sharding.mesh_sizes`` and ``fit_specs`` read."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """The reference's production mesh as a layout: ``(data 16, model 16)``,
    or ``(pod 2, data 16, model 16)`` across pods."""
    if multi_pod:
        return MeshLayout(POD_AXES, (2, 16, 16))
    return MeshLayout(AXES, (16, 16))


def make_host_mesh(*, device=None) -> HostMesh:
    """Whatever ranks run this program, as a ``(data, model)`` mesh with
    ``model = 1``: every rank of the process group ``dist.run_ranks``
    started, or, outside one, a one-rank mesh.  The rank computes on
    ``device`` (by default the card ``run_ranks`` gave it, or the card;
    ``device="cpu"`` where there is none)."""
    return HostMesh(partition_mesh(device=device))


def make_mesh(*, pod: int = 1, data: int, model: int, device=None) -> HostMesh:
    """A ``(pod = P, data = D, model = T)`` mesh over the ``P * D * T``
    ranks of the process group (``jax.make_mesh((P, D, T), ("pod", "data",
    "model"))``): rank ``r`` at ``(r // (D*T), (r // T) % D, r % T)``.
    Inside a group every rank must call it at once (each axis's groups are
    made by ``dist.new_group``, every group by every rank, in one order:
    model, data, pod, batch); an axis that spans every rank is the whole
    group, and so is the flattened one (``HostMesh.flat``).  Outside a
    group only ``(1, 1, 1)`` exists."""
    p, d, t = int(pod), int(data), int(model)
    world = partition_mesh(device=device)
    if p * d * t != world.world_size:
        shape = (d, t) if p == 1 else (p, d, t)
        raise ValueError(f"a {shape} mesh needs {p * d * t} ranks; the process group has "
                         f"{world.world_size}")
    r = world.rank
    i, j, k = r // (d * t), (r // t) % d, r % t  # pod, data, model

    def rank_of(a, b, c):
        return (a * d + b) * t + c

    def axis(size: int, index: int, members: list, mine: int) -> PartitionMesh:
        if size == 1:
            return _one_rank(world.device)
        if size == world.world_size:
            return PartitionMesh(size, index, world.device, world.backend, group=world.group)
        groups = [dist.new_group(m) for m in members]
        return PartitionMesh(size, index, world.device, world.backend, group=groups[mine])

    flat = axis(world.world_size, r, [], 0)  # every rank, index r: the whole group

    m_axis = axis(t, k, [[rank_of(a, b, c) for c in range(t)] for a in range(p)
                         for b in range(d)], i * d + j)
    d_axis = axis(d, j, [[rank_of(a, b, c) for b in range(d)] for a in range(p)
                         for c in range(t)], i * t + k)
    if p == 1:
        return HostMesh(d_axis, m_axis, flat=flat)
    p_axis = axis(p, i, [[rank_of(a, b, c) for a in range(p)] for b in range(d)
                         for c in range(t)], j * t + k)
    # the batch axes ("pod", "data"), pod-major: a PartitionMesh of its own
    # even where D = 1, so its collectives are counted apart from the pod's
    b_axis = axis(p * d, i * d + j, [[rank_of(a, b, c) for a in range(p) for b in range(d)]
                                     for c in range(t)], k)
    return HostMesh(d_axis, m_axis, p_axis, b_axis, flat)
