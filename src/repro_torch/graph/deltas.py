"""Streaming edge mutations over the static CSR: bounded delta buffers
merged only at window boundaries (the dense half of ``repro.graph.deltas``).

The static layout (``partitioned_edge_layout``) buys its fixed shapes and
sorted-segment fast paths by freezing the edge list at build time;
production traffic mutates the graph under it.  A two-phase contract keeps
both honest:

  * **buffer** (``EdgeDeltaBuffer``): inserts/deletes accumulate host-side
    in a capacity-bounded buffer -- O(1) per mutation, never touching device
    state, so the traversal hot path stays the static program.
  * **merge** (``apply_delta_buffer``): at a window boundary the buffer
    collapses into a *new* ``PartitionedGraph`` (same vertices, same
    partition map, mutated edge list, bumped ``_delta_generation``).  The
    new instance's caches start empty, so ``traversal.get_engine`` builds a
    fresh engine on it and the relax wrapper finds fresh ``row_ptr``
    tensors (its merge-path tile starts are kept per tensor): nothing built
    against the old edge list can be served for the new one.
    ``merge_buffer`` adds the optional repartition pass; the session, the
    executor and the service all merge through it.

**State carry** (``carry_state``): the dense engine keeps state in global
vertex order, which edge mutations do not disturb, so the carry is the
identity.  For *monotone* programs, continuing relaxation on the merged
graph from carried state reaches the same fixpoint as a fresh run IF every
source of an inserted edge with non-identity state re-enters the frontier
(``reactivate_sources``).  Deletes cannot be un-relaxed, so callers refuse
to carry state across a buffer with deletes and restart the query instead.

Not ported yet (they need the mesh layout, which comes with the multi-GPU
engine): ``delta_changed_devices`` and ``merged_mesh_layout``, the
incremental per-device rebuild, and the mesh branch of ``carry_state``
(``relayout_state``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.repartition import RepartitionConfig, incremental_repartition
from repro_torch.graph.structs import Graph, PartitionedGraph

DEFAULT_BUFFER_CAPACITY = 4096


class DeltaBufferFull(RuntimeError):
    """Raised when an ``EdgeDeltaBuffer`` exceeds its bounded capacity."""


@dataclasses.dataclass
class EdgeDeltaBuffer:
    """Bounded staging buffer of directed edge inserts and deletes.

    Mutations are *directed*: callers working with symmetrized graphs add
    both directions explicitly.  ``capacity`` bounds the total staged
    mutation count (inserts + deletes): the merge cost scales with buffer
    size.
    """

    capacity: int = DEFAULT_BUFFER_CAPACITY
    _ins_src: list = dataclasses.field(default_factory=list)
    _ins_dst: list = dataclasses.field(default_factory=list)
    _ins_w: list = dataclasses.field(default_factory=list)
    _del_src: list = dataclasses.field(default_factory=list)
    _del_dst: list = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self._ins_src) + len(self._del_src)

    @property
    def n_inserts(self) -> int:
        return len(self._ins_src)

    @property
    def n_deletes(self) -> int:
        return len(self._del_src)

    @property
    def has_deletes(self) -> bool:
        return bool(self._del_src)

    def _check_room(self, n: int):
        if len(self) + n > self.capacity:
            raise DeltaBufferFull(
                f"delta buffer over capacity: {len(self)} staged + {n} new "
                f"> {self.capacity}"
            )

    def insert(self, src: int, dst: int, weight: float | None = None):
        self._check_room(1)
        self._ins_src.append(int(src))
        self._ins_dst.append(int(dst))
        self._ins_w.append(None if weight is None else float(weight))

    def insert_many(self, src, dst, weights=None):
        src = np.asarray(src).ravel()
        dst = np.asarray(dst).ravel()
        self._check_room(src.size)
        w = [None] * src.size if weights is None else list(np.asarray(weights).ravel())
        for s, d, x in zip(src, dst, w):
            self._ins_src.append(int(s))
            self._ins_dst.append(int(d))
            self._ins_w.append(None if x is None else float(x))

    def delete(self, src: int, dst: int):
        self._check_room(1)
        self._del_src.append(int(src))
        self._del_dst.append(int(dst))

    def delete_many(self, src, dst):
        src = np.asarray(src).ravel()
        dst = np.asarray(dst).ravel()
        self._check_room(src.size)
        self._del_src.extend(int(s) for s in src)
        self._del_dst.extend(int(d) for d in dst)

    def clear(self):
        self._ins_src.clear()
        self._ins_dst.clear()
        self._ins_w.clear()
        self._del_src.clear()
        self._del_dst.clear()

    def inserts(self) -> tuple[np.ndarray, np.ndarray, list]:
        """(src [k], dst [k], weights list of float|None) staged inserts."""
        return (
            np.asarray(self._ins_src, dtype=np.int64),
            np.asarray(self._ins_dst, dtype=np.int64),
            list(self._ins_w),
        )

    def deletes(self) -> tuple[np.ndarray, np.ndarray]:
        return (
            np.asarray(self._del_src, dtype=np.int64),
            np.asarray(self._del_dst, dtype=np.int64),
        )


def apply_delta_buffer(
    pg: PartitionedGraph, buf: EdgeDeltaBuffer
) -> PartitionedGraph:
    """Collapse a delta buffer into a new ``PartitionedGraph``.

    Vertex set and partition map are unchanged (vertex churn is out of scope
    for this layer); the edge list loses every directed edge named by a
    delete (all parallel copies) and gains the staged inserts in buffer
    order.  The result is a fresh frozen instance with empty caches and
    ``_delta_generation`` bumped, so nothing built against the old edge list
    can be served for the new one.
    """
    if len(buf) == 0:
        return pg
    g = pg.graph
    n = g.n_vertices
    isrc, idst, iw = buf.inserts()
    dsrc, ddst = buf.deletes()
    for name, arr in (("insert", isrc), ("insert", idst),
                      ("delete", dsrc), ("delete", ddst)):
        if arr.size and (arr.min() < 0 or arr.max() >= n):
            raise ValueError(
                f"{name} names a vertex outside [0, {n}): "
                f"[{arr.min()}, {arr.max()}]"
            )
    keep = np.ones(g.n_edges, dtype=bool)
    if dsrc.size:
        g_key = g.src.astype(np.int64) * n + g.dst
        d_key = dsrc * n + ddst
        missing = ~np.isin(d_key, g_key)
        if missing.any():
            i = int(np.flatnonzero(missing)[0])
            raise ValueError(
                f"delete of absent edge ({dsrc[i]}, {ddst[i]})"
            )
        keep = ~np.isin(g_key, d_key)
    src = np.concatenate([g.src[keep], isrc.astype(np.int32)])
    dst = np.concatenate([g.dst[keep], idst.astype(np.int32)])
    if g.weights is None:
        if any(w is not None for w in iw):
            raise ValueError(
                "explicit insert weights on an unweighted graph "
                "(unit weights are implied; pass weight=None)"
            )
        weights = None
    else:
        wnew = np.asarray(
            [1.0 if w is None else w for w in iw], dtype=np.float32
        )
        weights = np.concatenate([g.weights[keep].astype(np.float32), wnew])
    new_g = Graph(n, src, dst, weights)
    new_pg = PartitionedGraph(new_g, pg.n_parts, pg.part_of_vertex)
    new_pg.__dict__["_delta_generation"] = (
        int(pg.__dict__.get("_delta_generation", 0)) + 1
    )
    return new_pg


def merge_buffer(pg: PartitionedGraph, buf: EdgeDeltaBuffer, repartition=None):
    """The window-boundary merge the session, the executor and the service
    share: ``apply_delta_buffer``, then one bounded repartition pass when
    ``repartition`` is set (a ``RepartitionConfig``, or ``True`` for the
    default one).  Returns ``(new_pg, RepartitionResult or None)``; a state
    carried across it goes through ``reactivate_sources`` with the buffer's
    insert sources.
    """
    new_pg = apply_delta_buffer(pg, buf)
    if not repartition:
        return new_pg, None
    rcfg = repartition if isinstance(repartition, RepartitionConfig) else RepartitionConfig()
    rep = incremental_repartition(new_pg, config=rcfg)
    return rep.pg, rep


def carry_state(old_layout, new_layout, state):
    """Carry in-flight window state across a merge, exactly.

    Dense engines (either layout ``None``) keep state in global vertex
    order, which edge mutations do not disturb: the carry is the identity.
    A mesh layout on both sides needs the multi-GPU engine's state relayout,
    which is not ported yet, and raises.
    """
    if old_layout is None or new_layout is None:
        return state
    raise NotImplementedError(
        "carrying state between mesh layouts comes with the multi-GPU engine"
    )


def _reactivate_rows(
    dist: torch.Tensor, frontier: torch.Tensor, idx: torch.Tensor, identity
) -> torch.Tensor:
    """A new frontier: ``frontier`` with the ``idx`` columns re-entered
    where their state is non-identity.

    The delta-merge correctness seam for monotone programs: an inserted
    edge's source may already be settled (inactive), yet the new edge has
    never been relaxed -- without reactivation the fixpoint would silently
    miss every path through the insert.  Monotonicity makes this sufficient:
    re-relaxing from carried state converges to the same fixpoint as a fresh
    run on the mutated graph.  The input frontier is not written: the
    batcher and the executor may still hold it.
    """
    hot = frontier.index_select(-1, idx) | (dist.index_select(-1, idx) != identity)
    return frontier.index_copy(-1, idx, hot)


def reactivate_sources(state, layout, sources: np.ndarray, *, identity):
    """Return ``state`` with inserted-edge sources re-activated.

    ``sources`` are global vertex ids (the distinct ``src`` endpoints of a
    buffer's inserts); ``layout`` is ``None`` on the dense engine, whose
    state is already in global order.  The update runs as torch ops on the
    state's device; the returned state holds a new frontier tensor.
    """
    sources = np.unique(np.asarray(sources, dtype=np.int64))
    if sources.size == 0:
        return state
    if layout is not None:
        raise NotImplementedError(
            "reactivating sources in a mesh layout comes with the multi-GPU engine"
        )
    idx = torch.as_tensor(sources, device=state.dist.device)
    frontier = _reactivate_rows(state.dist, state.frontier, idx, identity.item())
    return state._replace(frontier=frontier)
