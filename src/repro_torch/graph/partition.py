"""Graph partitioners and the partition-aware static edge layout.

The paper partitions with METIS (vertex-balanced, load factor 1.03, minimal
edge cut).  METIS is unavailable offline; ``bfs_grow_partition`` is a
multi-seed region-growing partitioner with a greedy boundary-refinement pass
that achieves the same *qualitative* regime: balanced vertex counts and
well-connected partitions (few, large subgraphs per partition).
``hash_partition`` reproduces Giraph's default (balanced but high cut).

``partitioned_edge_layout`` turns a ``PartitionedGraph`` into the static
CSR layout the device-resident traversal engine runs on: local and remote
edges split into two dst-sorted ``CsrEdgeLayout``s (so the inner closure
loop scans only local edges and the superstep-boundary exchange only remote
ones, with no per-edge ``is_local`` masking), each carrying the per-edge src
partition ids needed for the paper's work counters.  Built once per graph
and cached on the ``PartitionedGraph`` instance.

``mesh_edge_layout`` extends it to a fixed partition -> device map for the
multi-GPU engine (``graph.mesh_exchange``), with the incremental rebuild from
a previous layout and the hub mirrors.  Host-side numpy, byte-identical to
``repro.graph.partition``.  ``mesh_rank_layout`` builds one rank's block of
it alone: what a mesh rank runs on.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structs import (
    BoundedCache,
    CsrEdgeLayout,
    Graph,
    MeshEdgeLayout,
    MeshRankLayout,
    PartitionedGraph,
    dst_sorted_layout,
    mesh_layout_key,
)


@dataclasses.dataclass(frozen=True)
class PartitionedEdgeLayout:
    """Static traversal layout: dst-sorted local + remote edge sets.

    ``local_eid``/``remote_eid`` map each layout row back to the original
    edge-list index, so a per-program ``[E]`` edge-weight plane
    (``graph.program.VertexProgram.edge_plane``) permutes into layout order
    with one gather instead of a rebuild.
    """

    local: CsrEdgeLayout  # within-partition edges, dst ascending
    remote: CsrEdgeLayout  # cross-partition edges, dst ascending
    local_part: np.ndarray  # [E_local] int32 partition of each local edge
    remote_src_part: np.ndarray  # [E_remote] int32 src partition per remote edge
    local_eid: np.ndarray  # [E_local] int64 original edge index per local row
    remote_eid: np.ndarray  # [E_remote] int64 original edge index per remote row


def partitioned_edge_layout(pg: PartitionedGraph) -> PartitionedEdgeLayout:
    """The static edge layout for ``pg`` (cached on the instance)."""
    cached = pg.__dict__.get("_edge_layout")
    if cached is not None:
        return cached
    g = pg.graph
    local = pg.is_local_edge
    w = g.edge_weights
    part = pg.part_of_vertex.astype(np.int32)
    loc = dst_sorted_layout(g.n_vertices, g.src[local], g.dst[local], w[local])
    rem = dst_sorted_layout(g.n_vertices, g.src[~local], g.dst[~local], w[~local])
    layout = PartitionedEdgeLayout(
        local=loc,
        remote=rem,
        local_part=part[loc.src],
        remote_src_part=part[rem.src],
        local_eid=np.flatnonzero(local)[loc.perm],
        remote_eid=np.flatnonzero(~local)[rem.perm],
    )
    pg.__dict__["_edge_layout"] = layout
    return layout


def contiguous_device_map(n_parts: int, n_devices: int) -> np.ndarray:
    """Balanced static partition -> device assignment (contiguous blocks).

    Partition ``i`` goes to device ``i * n_devices // n_parts`` when
    ``n_parts >= n_devices`` (blocks differ by at most one partition); with
    more devices than partitions the first ``n_parts`` devices get one
    partition each and the rest stay empty -- a legal, if wasteful, mesh.
    """
    if n_parts <= 0 or n_devices <= 0:
        raise ValueError(f"need positive sizes, got P={n_parts} D={n_devices}")
    if n_parts >= n_devices:
        return (np.arange(n_parts, dtype=np.int64) * n_devices // n_parts).astype(
            np.int32
        )
    return np.arange(n_parts, dtype=np.int32)


#: layouts retained per (PartitionedGraph, canonical key); replanned runs can
#: visit many device maps, so the cache is LRU-bounded rather than unbounded
_LAYOUT_CACHE_MAX = 16

#: rank layouts retained per PartitionedGraph: the active one and the one an
#: engine on a merged graph adopts (a rank holds no layout it does not run)
_RANK_LAYOUT_CACHE_MAX = 2

#: incremental-rebuild bases retained per (device count, mirror knob) (one
#: mesh width is the common case; a handful covers elastic sweeps)
_LAST_BASE_CACHE_MAX = 4

#: hub plans retained per (pg, mirror_degree); a run uses one threshold, a
#: mirror sweep a handful
_HUB_PLAN_CACHE_MAX = 8


def _mirror_hub_plan(
    pg: PartitionedGraph, mirror_degree: int | None
) -> tuple[np.ndarray, np.ndarray]:
    """(hub_edge [E_remote] bool, nr_hub [P] int64) for a degree threshold.

    A *hub* is a vertex whose cross-partition in-degree (count of remote
    edges targeting it) meets ``mirror_degree``.  The predicate depends only
    on the partition map -- never on the device map -- so the hub set (and
    with it the mirrored collective signature) is stable across elastic
    relayout swaps.  ``mirror_degree=None`` selects no hubs.
    """
    cache = pg.__dict__.get("_mirror_hub_plans")
    if not isinstance(cache, BoundedCache):
        cache = BoundedCache(_HUB_PLAN_CACHE_MAX)
        pg.__dict__["_mirror_hub_plans"] = cache

    def build():
        layout = partitioned_edge_layout(pg)
        if mirror_degree is None:
            hub_edge = np.zeros(layout.remote.n_edges, dtype=bool)
        else:
            indeg = np.bincount(
                layout.remote.dst, minlength=pg.graph.n_vertices
            )
            hub_edge = indeg[layout.remote.dst] >= int(mirror_degree)
        nr_hub = np.bincount(
            layout.remote_src_part[hub_edge], minlength=pg.n_parts
        ).astype(np.int64)
        return hub_edge, nr_hub

    key = None if mirror_degree is None else int(mirror_degree)
    return cache.get_or_build(key, build)


@dataclasses.dataclass(frozen=True)
class _PartSlices:
    """Per-partition views into the static partition layout, built once per
    graph and reused by every mesh-layout (re)build.

    All selections preserve the global dst-ascending order of the underlying
    ``PartitionedEdgeLayout``, so a per-device edge list assembled as
    ``sort(concat(slices of its partitions))`` is *identical* to the
    ``flatnonzero`` scan over the full edge set -- incremental rebuilds
    produce byte-identical layouts.
    """

    verts: list  # [P] ascending vertex ids per partition
    lsel: list  # [P] indices into layout.local, dst-ascending
    rsel: list  # [P] indices into layout.remote, dst-ascending (by src part)
    rin: list  # [P] indices into layout.remote, dst-ascending (by dst part)
    nv: np.ndarray  # [P] vertex counts
    nl: np.ndarray  # [P] local-edge counts
    nr: np.ndarray  # [P] remote out-edge counts
    rdst_part: np.ndarray  # [E_remote] partition of each remote edge's dst
    reach: np.ndarray  # [P, P] bool: partition i has a remote edge into j


def _small_keys(labels: np.ndarray, n_groups: int) -> np.ndarray:
    """``labels`` in the narrowest unsigned type that holds ``n_groups``
    values: numpy's stable sort of 8- and 16-bit keys is a radix sort, and
    the order it gives is the same as for any wider type."""
    if n_groups <= 1 << 8:
        return labels.astype(np.uint8)
    if n_groups <= 1 << 16:
        return labels.astype(np.uint16)
    return labels


def _group_by(labels: np.ndarray, n_groups: int) -> list:
    """[n_groups] ascending index arrays, one per label value (stable)."""
    order = np.argsort(_small_keys(labels, n_groups), kind="stable")
    counts = np.bincount(labels, minlength=n_groups)
    return np.split(order, np.cumsum(counts)[:-1])


def _mesh_part_slices(pg: PartitionedGraph) -> _PartSlices:
    cached = pg.__dict__.get("_mesh_part_slices")
    if cached is not None:
        return cached
    layout = partitioned_edge_layout(pg)
    p = pg.n_parts
    part = pg.part_of_vertex.astype(np.int64)
    rdst_part = part[layout.remote.dst].astype(np.int32)
    reach = np.zeros((p, p), dtype=bool)
    reach[layout.remote_src_part, rdst_part] = True
    slices = _PartSlices(
        verts=_group_by(part, p),
        lsel=_group_by(layout.local_part, p),
        rsel=_group_by(layout.remote_src_part, p),
        rin=_group_by(rdst_part, p),
        nv=np.bincount(part, minlength=p),
        nl=np.bincount(layout.local_part, minlength=p),
        nr=np.bincount(layout.remote_src_part, minlength=p),
        rdst_part=rdst_part,
        reach=reach,
    )
    pg.__dict__["_mesh_part_slices"] = slices
    return slices


def _dev_sel(groups: list, parts: np.ndarray) -> np.ndarray:
    """Ascending union of a device's per-partition index slices --
    identical to the full ``flatnonzero`` scan of a from-scratch build."""
    if not parts.size:
        return np.empty(0, np.int64)
    if parts.size == 1:
        return np.asarray(groups[int(parts[0])])
    # a concatenation of ascending runs: the stable sort merges them
    return np.sort(np.concatenate([groups[i] for i in parts]), kind="stable")


def _check_map(pg, device_of_part, n_devices, mirror_degree):
    """The map as int32 and the mirror knob as int or None, both checked."""
    device_of_part = np.asarray(device_of_part, dtype=np.int32)
    if device_of_part.shape != (pg.n_parts,):
        raise ValueError(
            f"device_of_part has shape {device_of_part.shape}, "
            f"expected ({pg.n_parts},)"
        )
    if device_of_part.min() < 0 or device_of_part.max() >= n_devices:
        raise ValueError(
            f"device ids must lie in [0, {n_devices}), got "
            f"[{device_of_part.min()}, {device_of_part.max()}]"
        )
    if mirror_degree is not None:
        mirror_degree = int(mirror_degree)
        if mirror_degree < 1:
            raise ValueError(
                f"mirror_degree must be >= 1 or None, got {mirror_degree}"
            )
    return device_of_part, mirror_degree


def _mesh_pads(slices: _PartSlices, parts_of_dev: list, nr_hub: np.ndarray):
    """``(n_pad, e_local_pad, e_remote_pad, e_mirror_pad)`` from the cached
    per-partition counts (O(P), no edge scans)."""
    nv_dev = np.array([slices.nv[q].sum() for q in parts_of_dev])
    nl_dev = np.array([slices.nl[q].sum() for q in parts_of_dev])
    nr_wire = slices.nr - nr_hub
    nr_dev = np.array([nr_wire[q].sum() for q in parts_of_dev])
    nm_dev = np.array([nr_hub[q].sum() for q in parts_of_dev])
    return (
        max(1, int(nv_dev.max())),
        max(1, int(nl_dev.max())),
        max(1, int(nr_dev.max())),
        int(nm_dev.max()),
    )


def _affected(old_map, new_map, changed_devices, slices, parts_of_dev, d_n):
    """``(changed, src_aff)`` [D] bool: devices whose partition set (or,
    through ``changed_devices``, edge content) changed, and the sender
    devices whose remote blocks must be re-sorted and re-slotted -- the
    changed ones and every device sending into a partition on one."""
    moved = np.flatnonzero(old_map != new_map)
    changed = np.zeros(d_n, dtype=bool)
    changed[old_map[moved]] = True
    changed[new_map[moved]] = True
    if changed_devices is not None:
        # delta-merge seam: devices whose *edge content* changed under an
        # unchanged map (graph.deltas computes the exact set per plane)
        changed |= np.asarray(changed_devices, dtype=bool)
    # parts whose device-local rows may have shifted = parts hosted on a
    # changed device; src devices reaching any of them re-sort and re-slot
    j_shift = changed[new_map]  # [P] bool
    sends_into_shifted = slices.reach[:, j_shift].any(axis=1)  # [P]
    src_aff = changed.copy()
    for d in range(d_n):
        if not src_aff[d] and sends_into_shifted[parts_of_dev[d]].any():
            src_aff[d] = True
    return changed, src_aff


def _slot_order(sel, block, dst, d_n: int, n: int):
    """Remote edge rows ``sel`` (dst-ascending) ordered by ``(block, dst)``,
    the distinct ``block * n + dst`` keys and each edge's key index: the
    slot structure of one sender's plane (``block`` = destination device)
    or of one receiver's (``block`` = sending device).

    A stable sort by ``block`` of a dst-ascending sequence is the
    ``lexsort((dst, block))`` order, and the keys come out sorted, so their
    distinct values are a run-boundary scan rather than ``np.unique``.
    """
    if not sel.size:
        return sel, np.empty(0, np.int64), np.empty(0, np.int64)
    order = np.argsort(_small_keys(block, d_n), kind="stable")
    key = block[order].astype(np.int64) * n + dst[order]
    first = np.empty(key.size, dtype=bool)
    first[0] = True
    np.not_equal(key[1:], key[:-1], out=first[1:])
    return sel[order], key[first], np.cumsum(first) - 1


def _local_rows(layout, sel, e_pad: int, n_pad: int, d: int, pos_of_vertex):
    """One device's padded local plane ``(src, dst, w, valid, eid)``; padding
    dst rows are ``n_pad - 1``, >= any real row, so dst stays ascending."""
    loc, m = layout.local, sel.size
    src = np.zeros(e_pad, dtype=np.int32)
    dst = np.full(e_pad, n_pad - 1, dtype=np.int32)
    w = np.zeros(e_pad, dtype=np.float32)
    valid = np.zeros(e_pad, dtype=bool)
    eid = np.zeros(e_pad, dtype=np.int64)
    src[:m] = pos_of_vertex[loc.src[sel]] - d * n_pad
    dst[:m] = pos_of_vertex[loc.dst[sel]] - d * n_pad
    w[:m] = loc.weights[sel]
    valid[:m] = True
    eid[:m] = sel
    return src, dst, w, valid, eid


def _slot_rows(layout, order, e_pad: int, pad: int, d_n: int, d: int, n_pad: int, pos_of_vertex):
    """One sender's padded wire (or mirror) plane ``(src, w, slot, valid,
    eid)`` from its ``_slot_order``, and its receive side ``(dst device,
    slot, dst device-local row)`` per distinct key (None without edges).
    Padding slots are ``D * pad - 1``, the last, so slots stay ascending."""
    rem = layout.remote
    n = pos_of_vertex.shape[0]
    sel, uniq, inv = order
    m = sel.size
    src = np.zeros(e_pad, dtype=np.int32)
    w = np.zeros(e_pad, dtype=np.float32)
    slot = np.full(e_pad, max(0, d_n * pad - 1), dtype=np.int32)
    valid = np.zeros(e_pad, dtype=bool)
    eid = np.zeros(e_pad, dtype=np.int64)
    recv = None
    if m:
        u_dd = uniq // n
        # slot rank within each dst-device group (uniq is (dd, dst)-sorted)
        first_of_dd = np.searchsorted(u_dd, np.arange(d_n))
        slot_of_uniq = np.arange(uniq.size) - first_of_dd[u_dd]
        src[:m] = pos_of_vertex[rem.src[sel]] - d * n_pad
        w[:m] = rem.weights[sel]
        slot[:m] = (u_dd[inv] * pad + slot_of_uniq[inv]).astype(np.int32)
        valid[:m] = True
        eid[:m] = sel
        # receive side: block (d -> dd) slot s lands on the dst vertex's
        # device-local row on device dd
        recv = (u_dd, slot_of_uniq, (pos_of_vertex[uniq % n] - u_dd * n_pad).astype(np.int32))
    return (src, w, slot, valid, eid), recv


#: sentinel: pick the most recently built layout for this (pg, D) as the
#: incremental base (None forces a from-scratch build)
_AUTO_BASE = object()


def mesh_edge_layout(
    pg: PartitionedGraph,
    device_of_part: np.ndarray,
    n_devices: int,
    *,
    base: MeshEdgeLayout | None | object = _AUTO_BASE,
    mirror_degree: int | None = None,
    changed_devices: np.ndarray | None = None,
) -> MeshEdgeLayout:
    """Build the static mesh-aware layout for a fixed partition -> device map.

    Host-side numpy, cached per ``(pg, mesh_layout_key(...), mirror_degree)``
    (LRU-bounded: dynamic re-layout visits a map per replan).  See
    ``structs.MeshEdgeLayout`` for the contract; the key invariants preserved
    from the single-device layout are (a) per-device local ``dst`` rows stay
    ascending (a device-filtered subsequence of the globally dst-sorted local
    edges, renumbered by a per-device monotone map), and (b) per-device
    remote edges are ``(dst_device, dst_vertex)``-sorted so wire-slot ids
    ascend too -- every plane is a valid CSR for the relax kernel
    (``MeshEdgeLayout.row_ptr``).  A mesh rank builds only its own block
    (``mesh_rank_layout``); the whole layout is for one process that needs
    every rank's planes.

    ``mirror_degree`` selects hub destinations (``_mirror_hub_plan``) whose
    incoming remote edges move to the structurally identical *mirror* plane
    (``msrc``/``mslot``/... with ``m_pad`` slots per block); ``None`` (the
    default) and zero-hub graphs build layouts whose pre-existing fields are
    byte-identical to an unmirrored build, with zero-width mirror arrays.

    **Incremental rebuild** (the dynamic re-layout hot path): when ``base`` is
    a previously built layout for the same ``(pg, n_devices)`` (the default
    picks the most recent one), only the per-device blocks the map change
    actually touches are recomputed from the cached per-partition slices
    (``_mesh_part_slices``):

      * vertex/local-edge blocks of devices whose partition set changed,
      * remote/wire blocks of src devices that are changed themselves OR send
        into any partition hosted on a changed device (their
        ``(dst_device, dst_vertex)`` sort and receive rows shift),

    everything else is copied from ``base``.  If any pad shape
    (``n_pad``/``e_local_pad``/``e_remote_pad``/``w_pad``) differs, the build
    degrades to from-scratch -- reuse is only valid shape-stable.  Either
    path produces the byte-identical canonical layout; the chosen path is
    recorded in ``layout.__dict__['_build_info']``.
    """
    device_of_part, mirror_degree = _check_map(pg, device_of_part, n_devices, mirror_degree)
    cache = pg.__dict__.get("_mesh_layouts")
    if not isinstance(cache, BoundedCache):
        cache = BoundedCache(_LAYOUT_CACHE_MAX)
        pg.__dict__["_mesh_layouts"] = cache
    generation = int(pg.__dict__.get("_delta_generation", 0))
    key = mesh_layout_key(device_of_part, n_devices, generation) + (
        mirror_degree,
    )
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    last = pg.__dict__.get("_mesh_layout_last")
    if not isinstance(last, BoundedCache):
        last = BoundedCache(_LAST_BASE_CACHE_MAX)
        pg.__dict__["_mesh_layout_last"] = last
    last_key = (int(n_devices), mirror_degree)
    if base is _AUTO_BASE:
        base = last.get(last_key)
    if base is not None and (
        base.n_devices != int(n_devices)
        or base.n_parts != pg.n_parts
        or base.n_vertices != pg.graph.n_vertices
        or base.mirror_degree != mirror_degree
    ):
        base = None
    if base is not None and base.delta_generation != generation:
        # Cross-generation reuse (the delta-merge seam) is only sound when the
        # caller names the devices whose edge content changed; without the
        # mask the map-diff detection below would wrongly copy stale blocks.
        if changed_devices is None:
            base = None

    out = _build_mesh_layout(
        pg, device_of_part, int(n_devices), base, mirror_degree,
        changed_devices=changed_devices,
    )
    cache.put(key, out)
    last.put(last_key, out)
    return out


def _build_mesh_layout(
    pg: PartitionedGraph,
    device_of_part: np.ndarray,
    d_n: int,
    base: MeshEdgeLayout | None,
    mirror_degree: int | None = None,
    changed_devices: np.ndarray | None = None,
) -> MeshEdgeLayout:
    layout = partitioned_edge_layout(pg)
    slices = _mesh_part_slices(pg)
    n = pg.graph.n_vertices
    parts_of_dev = _group_by(device_of_part.astype(np.int64), d_n)
    dev_of_vertex = device_of_part[pg.part_of_vertex]
    hub_edge, nr_hub = _mirror_hub_plan(pg, mirror_degree)
    pads = _mesh_pads(slices, parts_of_dev, nr_hub)
    n_pad, e_local_pad, e_remote_pad, e_mirror_pad = pads

    # -- which devices must be rebuilt ---------------------------------------
    all_devs = np.ones(d_n, dtype=bool)
    if base is None or pads != (
        base.n_pad, base.e_local_pad, base.e_remote_pad, base.e_mirror_pad
    ):
        vert_aff = src_aff = all_devs
        base = None
    else:
        vert_aff, src_aff = _affected(
            base.device_of_part, device_of_part, changed_devices, slices, parts_of_dev, d_n
        )

    # -- vertex plane: device-major permutation ------------------------------
    if base is None:
        pos_of_vertex = np.empty(n, dtype=np.int64)
        vertex_of_pos = np.full(d_n * n_pad, -1, dtype=np.int64)
        part_of_pos = np.zeros((d_n, n_pad), dtype=np.int32)
        pos_valid = np.zeros((d_n, n_pad), dtype=bool)
    else:
        pos_of_vertex = base.pos_of_vertex.copy()
        vertex_of_pos = base.vertex_of_pos.copy()
        part_of_pos = base.part_of_pos.copy()
        pos_valid = base.pos_valid.copy()

    for d in np.flatnonzero(vert_aff):
        verts = _dev_sel(slices.verts, parts_of_dev[d])
        pos_of_vertex[verts] = d * n_pad + np.arange(verts.size)
        vertex_of_pos[d * n_pad : d * n_pad + verts.size] = verts
        vertex_of_pos[d * n_pad + verts.size : (d + 1) * n_pad] = -1
        part_of_pos[d] = 0
        part_of_pos[d, : verts.size] = pg.part_of_vertex[verts]
        pos_valid[d] = False
        pos_valid[d, : verts.size] = True

    # -- local edges: filter per device, renumber to device-local rows -------
    if base is None:
        lsrc = np.zeros((d_n, e_local_pad), dtype=np.int32)
        ldst = np.full((d_n, e_local_pad), n_pad - 1, dtype=np.int32)
        lw = np.zeros((d_n, e_local_pad), dtype=np.float32)
        lpart = np.zeros((d_n, e_local_pad), dtype=np.int32)
        lvalid = np.zeros((d_n, e_local_pad), dtype=bool)
        l_eid = np.zeros((d_n, e_local_pad), dtype=np.int64)
    else:
        lsrc = base.lsrc.copy()
        ldst = base.ldst.copy()
        lw = base.lw.copy()
        lpart = base.lpart.copy()
        lvalid = base.lvalid.copy()
        l_eid = base.l_eid.copy()
    for d in np.flatnonzero(vert_aff):
        sel = _dev_sel(slices.lsel, parts_of_dev[d])  # ascending rows == global dst order
        lsrc[d], ldst[d], lw[d], lvalid[d], l_eid[d] = _local_rows(
            layout, sel, e_local_pad, n_pad, d, pos_of_vertex
        )
        lpart[d] = 0
        lpart[d, : sel.size] = layout.local_part[sel]

    # -- remote edges: (src_device, dst_device) blocks + wire slots ----------
    # with mirroring, hub-targeting remote edges leave the wire plane for the
    # structurally identical mirror plane (one slot per (owner_device, hub))
    rem = layout.remote
    remote_block_edges = np.zeros((d_n, d_n), dtype=np.int64)
    wire_slots = np.zeros((d_n, d_n), dtype=np.int64)
    mirror_block_edges = np.zeros((d_n, d_n), dtype=np.int64)
    mirror_slots = np.zeros((d_n, d_n), dtype=np.int64)
    if base is not None:
        keep = ~src_aff
        remote_block_edges[keep] = base.remote_block_edges[keep]
        wire_slots[keep] = base.wire_slots[keep]
        mirror_block_edges[keep] = base.mirror_block_edges[keep]
        mirror_slots[keep] = base.mirror_slots[keep]
    # first pass: per-block raw and distinct-dst counts fix the pad shapes
    per_dev: dict = {}
    per_dev_m: dict = {}

    def _first_pass(devs: np.ndarray) -> None:
        for d in devs:
            sel = _dev_sel(slices.rsel, parts_of_dev[d])
            hub = hub_edge[sel]
            for store, blocks, slots, s in (
                (per_dev, remote_block_edges, wire_slots, sel[~hub]),
                (per_dev_m, mirror_block_edges, mirror_slots, sel[hub]),
            ):
                bd = dev_of_vertex[rem.dst[s]]
                store[int(d)] = order = _slot_order(s, bd, rem.dst[s], d_n, n)
                blocks[d] = np.bincount(bd, minlength=d_n)
                slots[d] = np.bincount(order[1] // n, minlength=d_n)

    _first_pass(np.flatnonzero(src_aff))
    w_pad = max(1, int(wire_slots.max()))
    m_pad = int(mirror_slots.max())
    if base is not None and (w_pad != base.w_pad or m_pad != base.m_pad):
        # slot encoding (dd * pad + rank) is global: a w_pad / m_pad change
        # invalidates every block -- degrade to the from-scratch path
        base = None
        vert_aff = src_aff = all_devs
        _first_pass(np.flatnonzero(~np.isin(np.arange(d_n), list(per_dev))))

    rebuilt = np.flatnonzero(src_aff | vert_aff)
    if base is None:
        rsrc = np.zeros((d_n, e_remote_pad), dtype=np.int32)
        rw = np.zeros((d_n, e_remote_pad), dtype=np.float32)
        rslot = np.full((d_n, e_remote_pad), d_n * w_pad - 1, dtype=np.int32)
        rpart = np.zeros((d_n, e_remote_pad), dtype=np.int32)
        rvalid = np.zeros((d_n, e_remote_pad), dtype=bool)
        r_eid = np.zeros((d_n, e_remote_pad), dtype=np.int64)
        recv_idx = np.zeros((d_n, d_n, w_pad), dtype=np.int32)
        msrc = np.zeros((d_n, e_mirror_pad), dtype=np.int32)
        mw = np.zeros((d_n, e_mirror_pad), dtype=np.float32)
        mslot = np.full(
            (d_n, e_mirror_pad), max(0, d_n * m_pad - 1), dtype=np.int32
        )
        mpart = np.zeros((d_n, e_mirror_pad), dtype=np.int32)
        mvalid = np.zeros((d_n, e_mirror_pad), dtype=bool)
        m_eid = np.zeros((d_n, e_mirror_pad), dtype=np.int64)
        mrecv_idx = np.zeros((d_n, d_n, m_pad), dtype=np.int32)
    else:
        rsrc = base.rsrc.copy()
        rw = base.rw.copy()
        rslot = base.rslot.copy()
        rpart = base.rpart.copy()
        rvalid = base.rvalid.copy()
        r_eid = base.r_eid.copy()
        recv_idx = base.recv_idx.copy()
        msrc = base.msrc.copy()
        mw = base.mw.copy()
        mslot = base.mslot.copy()
        mpart = base.mpart.copy()
        mvalid = base.mvalid.copy()
        m_eid = base.m_eid.copy()
        mrecv_idx = base.mrecv_idx.copy()
    part32 = pg.part_of_vertex.astype(np.int32)
    for d in np.flatnonzero(src_aff):
        # the wire plane, then the mirror plane: the same construction over
        # the hub-targeting edges, with mirror slots in place of wire slots
        for order, pad, e_pad, planes, part_rows, recv_all in (
            (per_dev[int(d)], w_pad, e_remote_pad, (rsrc, rw, rslot, rvalid, r_eid),
             rpart, recv_idx),
            (per_dev_m[int(d)], m_pad, e_mirror_pad, (msrc, mw, mslot, mvalid, m_eid),
             mpart, mrecv_idx),
        ):
            rows, recv = _slot_rows(layout, order, e_pad, pad, d_n, d, n_pad, pos_of_vertex)
            for dst_arr, row in zip(planes, rows):
                dst_arr[d] = row
            sel = order[0]
            part_rows[d] = 0
            part_rows[d, : sel.size] = part32[rem.src[sel]]
            recv_all[:, d, :] = 0
            if recv is not None:
                u_dd, slot_of_uniq, rows_on_dd = recv
                recv_all[u_dd, d, slot_of_uniq] = rows_on_dd

    out = MeshEdgeLayout(
        n_devices=d_n,
        n_vertices=n,
        n_parts=pg.n_parts,
        device_of_part=device_of_part,
        n_pad=n_pad,
        pos_of_vertex=pos_of_vertex,
        vertex_of_pos=vertex_of_pos,
        part_of_pos=part_of_pos,
        pos_valid=pos_valid,
        e_local_pad=e_local_pad,
        lsrc=lsrc,
        ldst=ldst,
        lw=lw,
        lpart=lpart,
        lvalid=lvalid,
        l_eid=l_eid,
        e_remote_pad=e_remote_pad,
        w_pad=w_pad,
        rsrc=rsrc,
        rw=rw,
        rslot=rslot,
        rpart=rpart,
        rvalid=rvalid,
        r_eid=r_eid,
        recv_idx=recv_idx,
        wire_slots=wire_slots,
        remote_block_edges=remote_block_edges,
        mirror_degree=mirror_degree,
        e_mirror_pad=e_mirror_pad,
        m_pad=m_pad,
        msrc=msrc,
        mw=mw,
        mslot=mslot,
        mpart=mpart,
        mvalid=mvalid,
        m_eid=m_eid,
        mrecv_idx=mrecv_idx,
        mirror_slots=mirror_slots,
        mirror_block_edges=mirror_block_edges,
        delta_generation=int(pg.__dict__.get("_delta_generation", 0)),
    )
    out.__dict__["_build_info"] = {
        "incremental": base is not None,
        "devices_rebuilt": int(rebuilt.size),
        "devices_total": d_n,
    }
    return out


# -- one rank's block -----------------------------------------------------------


def mesh_rank_layout(
    pg: PartitionedGraph,
    device_of_part: np.ndarray,
    n_devices: int,
    rank: int,
    *,
    base: MeshRankLayout | None = None,
    mirror_degree: int | None = None,
    changed_devices: np.ndarray | None = None,
    mesh=None,
) -> MeshRankLayout:
    """Rank ``rank``'s block of ``mesh_edge_layout(pg, device_of_part,
    n_devices, mirror_degree=...)``, field for field, built without the
    other ranks' planes.

    The pads ``n_pad``/``e_*_pad`` come from the per-partition counts
    (O(P)); the vertex permutation is global (O(n)); the rank's own local
    and out planes cost O(its edges) and its receive maps O(the remote
    edges into its partitions).  Only ``w_pad``/``m_pad`` depend on every
    sender's distinct destinations: each rank counts its own row of the
    ``[D, D]`` block counts and ``mesh`` gathers the rows (a collective:
    every rank of the mesh builds the same map at once).  Without ``mesh``
    the other rows are counted here, from the whole remote edge set.

    ``base`` (this rank's layout under another map or graph generation;
    the latter only with ``changed_devices``, as ``mesh_edge_layout``) lets
    the build reuse the planes the change leaves alone: the local plane
    unless this rank's partitions changed, the out planes unless this rank
    must re-slot (``_affected``), the receive maps unless a sender into
    this rank must.  A pad change forces a full rebuild.  What was rebuilt
    is recorded in ``layout.__dict__['_build_info']``.  The result is
    cached on ``pg`` (the last ``_RANK_LAYOUT_CACHE_MAX`` maps).
    """
    device_of_part, mirror_degree = _check_map(pg, device_of_part, n_devices, mirror_degree)
    d_n, rank = int(n_devices), int(rank)
    if not 0 <= rank < d_n:
        raise ValueError(f"rank {rank} is not in [0, {d_n})")
    if mesh is not None and (int(mesh.world_size), int(mesh.rank)) != (d_n, rank):
        raise ValueError(
            f"rank {rank} of {d_n} asked for through mesh rank {mesh.rank} of {mesh.world_size}"
        )
    generation = int(pg.__dict__.get("_delta_generation", 0))
    key = (mesh_layout_key(device_of_part, d_n, generation) + (mirror_degree,), rank)
    cache = pg.__dict__.get("_mesh_rank_layouts")
    if not isinstance(cache, BoundedCache):
        cache = pg.__dict__["_mesh_rank_layouts"] = BoundedCache(_RANK_LAYOUT_CACHE_MAX)
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    if base is not None and (
        (base.n_devices, base.rank, base.n_parts, base.n_vertices, base.mirror_degree)
        != (d_n, rank, pg.n_parts, pg.graph.n_vertices, mirror_degree)
        or (base.delta_generation != generation and changed_devices is None)
    ):
        base = None
    return cache.put(key, _build_mesh_rank_layout(
        pg, device_of_part, d_n, rank, base, mirror_degree, changed_devices, mesh,
    ))


def _build_mesh_rank_layout(
    pg, device_of_part, d_n, d, base, mirror_degree, changed_devices, mesh
) -> MeshRankLayout:
    layout = partitioned_edge_layout(pg)
    slices = _mesh_part_slices(pg)
    rem = layout.remote
    n = pg.graph.n_vertices
    parts_of_dev = _group_by(device_of_part.astype(np.int64), d_n)
    dev_of_vertex = device_of_part[pg.part_of_vertex]
    hub_edge, nr_hub = _mirror_hub_plan(pg, mirror_degree)
    pads = _mesh_pads(slices, parts_of_dev, nr_hub)
    n_pad, e_local_pad, e_remote_pad, e_mirror_pad = pads
    if base is not None and pads != (
        base.n_pad, base.e_local_pad, base.e_remote_pad, base.e_mirror_pad
    ):
        base = None
    if base is None:
        changed = src_aff = np.ones(d_n, dtype=bool)
    else:
        changed, src_aff = _affected(
            base.device_of_part, device_of_part, changed_devices, slices, parts_of_dev, d_n
        )
    rebuilt = []

    # -- the vertex permutation (global) and this rank's rows ---------------
    if base is not None and not changed.any():
        pos_of_vertex = base.pos_of_vertex
    else:
        pos_of_vertex = np.empty(n, dtype=np.int64)
        for dev in range(d_n):
            verts = _dev_sel(slices.verts, parts_of_dev[dev])
            pos_of_vertex[verts] = dev * n_pad + np.arange(verts.size)
    verts = _dev_sel(slices.verts, parts_of_dev[d])
    vertex_of_pos = np.full(n_pad, -1, dtype=np.int64)
    vertex_of_pos[: verts.size] = verts
    part_of_pos = np.zeros(n_pad, dtype=np.int32)
    part_of_pos[: verts.size] = pg.part_of_vertex[verts]
    pos_valid = np.zeros(n_pad, dtype=bool)
    pos_valid[: verts.size] = True

    # -- the local plane -----------------------------------------------------
    if base is not None and not changed[d]:
        local = (base.lsrc, base.ldst, base.lw, base.lvalid, base.l_eid)
    else:
        sel = _dev_sel(slices.lsel, parts_of_dev[d])
        local = _local_rows(layout, sel, e_local_pad, n_pad, d, pos_of_vertex)
        rebuilt.append("local")

    # -- the out planes' slot structure and this rank's row of block counts --
    def sender_orders(dev):
        sel = _dev_sel(slices.rsel, parts_of_dev[dev])
        hub = hub_edge[sel]
        out = []
        for s in (sel[~hub], sel[hub]):
            out.append(_slot_order(s, dev_of_vertex[rem.dst[s]], rem.dst[s], d_n, n))
        return out

    def count_row(orders):
        # (remote_block_edges, wire_slots, mirror_block_edges, mirror_slots)
        row = np.zeros((4, d_n), dtype=np.int64)
        for i, (sel, uniq, _) in enumerate(orders):
            row[2 * i] = np.bincount(dev_of_vertex[rem.dst[sel]], minlength=d_n)
            row[2 * i + 1] = np.bincount(uniq // n, minlength=d_n)
        return row

    reuse_out = base is not None and not src_aff[d]
    orders = None if reuse_out else sender_orders(d)
    own_row = np.stack([
        base.remote_block_edges[d], base.wire_slots[d],
        base.mirror_block_edges[d], base.mirror_slots[d],
    ]) if reuse_out else count_row(orders)
    if mesh is not None:
        counts = mesh.gather_host(own_row)  # [D, 4, D]
    else:
        counts = np.stack([
            own_row if dev == d else count_row(sender_orders(dev)) for dev in range(d_n)
        ])
    remote_block_edges, wire_slots, mirror_block_edges, mirror_slots = (
        np.ascontiguousarray(counts[:, i]) for i in range(4)
    )
    w_pad = max(1, int(wire_slots.max()))
    m_pad = int(mirror_slots.max())
    if base is not None and (w_pad, m_pad) != (base.w_pad, base.m_pad):
        # the slot encoding (dd * pad + rank) changed: every plane re-slots
        base, src_aff = None, np.ones(d_n, dtype=bool)
        reuse_out = False
        orders = orders or sender_orders(d)

    # -- the out planes --------------------------------------------------------
    if reuse_out:
        wire = (base.rsrc, base.rw, base.rslot, base.rvalid, base.r_eid)
        mirror = (base.msrc, base.mw, base.mslot, base.mvalid, base.m_eid)
    else:
        wire = _slot_rows(layout, orders[0], e_remote_pad, w_pad, d_n, d, n_pad, pos_of_vertex)[0]
        mirror = _slot_rows(layout, orders[1], e_mirror_pad, m_pad, d_n, d, n_pad, pos_of_vertex)[0]
        rebuilt.append("out")

    # -- the receive maps: the slots each sender's block into this rank
    # holds are its distinct destinations here, in ascending order --------
    senders = (wire_slots[:, d] > 0) | (mirror_slots[:, d] > 0)
    if base is not None:
        senders |= (base.wire_slots[:, d] > 0) | (base.mirror_slots[:, d] > 0)
    if base is not None and not (src_aff & senders).any():
        recv_idx, mrecv_idx = base.recv_idx, base.mrecv_idx
    else:
        sel = _dev_sel(slices.rin, parts_of_dev[d])
        hub = hub_edge[sel]
        maps = []
        for s, pad in ((sel[~hub], w_pad), (sel[hub], m_pad)):
            recv = np.zeros((d_n, pad), dtype=np.int32)
            _, uniq, _ = _slot_order(
                s, device_of_part[layout.remote_src_part[s]], rem.dst[s], d_n, n
            )
            u_sd = uniq // n
            slot = np.arange(uniq.size) - np.searchsorted(u_sd, np.arange(d_n))[u_sd]
            recv[u_sd, slot] = pos_of_vertex[uniq % n] - d * n_pad
            maps.append(recv)
        recv_idx, mrecv_idx = maps
        rebuilt.append("recv")

    out = MeshRankLayout(
        rank=d, n_devices=d_n, n_vertices=n, n_parts=pg.n_parts,
        device_of_part=device_of_part, n_pad=n_pad, pos_of_vertex=pos_of_vertex,
        vertex_of_pos=vertex_of_pos, part_of_pos=part_of_pos, pos_valid=pos_valid,
        e_local_pad=e_local_pad,
        **dict(zip(("lsrc", "ldst", "lw", "lvalid", "l_eid"), local)),
        e_remote_pad=e_remote_pad, w_pad=w_pad,
        **dict(zip(("rsrc", "rw", "rslot", "rvalid", "r_eid"), wire)),
        recv_idx=recv_idx, wire_slots=wire_slots, remote_block_edges=remote_block_edges,
        mirror_degree=mirror_degree, e_mirror_pad=e_mirror_pad, m_pad=m_pad,
        **dict(zip(("msrc", "mw", "mslot", "mvalid", "m_eid"), mirror)),
        mrecv_idx=mrecv_idx, mirror_slots=mirror_slots, mirror_block_edges=mirror_block_edges,
        delta_generation=int(pg.__dict__.get("_delta_generation", 0)),
    )
    out.__dict__["_build_info"] = {
        "incremental": base is not None, "rebuilt": rebuilt, "devices_total": d_n,
    }
    return out


def hash_partition(g: Graph, n_parts: int, *, seed: int = 0) -> PartitionedGraph:
    """Giraph-style hashed placement: balanced vertices, terrible edge cut."""
    mix = np.arange(g.n_vertices, dtype=np.int64) * np.int64(2654435761) + seed
    part = ((mix >> 16) % n_parts).astype(np.int32)
    return PartitionedGraph(g, n_parts, part)


def bfs_grow_partition(
    g: Graph,
    n_parts: int,
    *,
    seed: int = 0,
    balance: float = 1.03,
    refine_sweeps: int = 2,
) -> PartitionedGraph:
    """Multi-seed BFS region growing + greedy cut refinement.

    1. Pick ``n_parts`` seeds spread apart (iterative farthest-first on hops).
    2. Round-robin frontier expansion; each region claims unassigned neighbors
       until it reaches the balance cap ceil(balance * n/k).
    3. ``refine_sweeps`` passes move boundary vertices to the neighboring
       partition holding the majority of their edges when balance permits.
    """
    rng = np.random.default_rng(seed)
    n, k = g.n_vertices, n_parts
    cap = int(np.ceil(balance * n / k))
    row_ptr, col, _ = g.csr

    # --- farthest-first seed selection on an undirected view ---------------
    seeds = [int(rng.integers(n))]
    dist = _bfs_hops(row_ptr, col, n, seeds[0])
    for _ in range(k - 1):
        cand = int(np.argmax(np.where(np.isfinite(dist), dist, -1.0)))
        seeds.append(cand)
        dist = np.minimum(dist, _bfs_hops(row_ptr, col, n, cand))

    part = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(k, dtype=np.int64)
    frontiers: list[np.ndarray] = []
    for p, s in enumerate(seeds):
        if part[s] == -1:
            part[s] = p
            sizes[p] += 1
        frontiers.append(np.array([s], dtype=np.int64))

    # --- round-robin growth -------------------------------------------------
    while (part == -1).any():
        grew = False
        for p in range(k):
            if sizes[p] >= cap or frontiers[p].size == 0:
                continue
            f = frontiers[p]
            nbrs = _neighbors_of(row_ptr, col, f)
            nbrs = nbrs[part[nbrs] == -1]
            if nbrs.size == 0:
                frontiers[p] = np.array([], dtype=np.int64)
                continue
            nbrs = _distinct_vertices(nbrs, n)
            room = cap - sizes[p]
            if nbrs.size > room:
                nbrs = nbrs[:room]
            part[nbrs] = p
            sizes[p] += nbrs.size
            frontiers[p] = nbrs
            grew = True
        if not grew:
            # disconnected leftovers or all regions full: assign remaining to
            # smallest partitions round-robin
            rest = np.flatnonzero(part == -1)
            order = np.argsort(sizes)
            for i, v in enumerate(rest):
                p = int(order[i % k])
                part[v] = p
                sizes[p] += 1
            break

    # --- greedy boundary refinement -----------------------------------------
    for _ in range(refine_sweeps):
        part = _refine_once(g, part, k, cap)

    return PartitionedGraph(g, k, part)


def _bfs_hops(row_ptr: np.ndarray, col: np.ndarray, n: int, source: int) -> np.ndarray:
    dist = np.full(n, np.inf)
    dist[source] = 0
    seen = np.zeros(n, dtype=bool)  # isfinite(dist), a byte a vertex
    seen[source] = True
    frontier = np.array([source], dtype=np.int64)
    d = 0
    while frontier.size:
        d += 1
        nbrs = _neighbors_of(row_ptr, col, frontier)
        nbrs = _distinct_vertices(nbrs[~seen[nbrs]], n)
        dist[nbrs] = d
        seen[nbrs] = True
        frontier = nbrs
    return dist


def _distinct_vertices(vs: np.ndarray, n: int) -> np.ndarray:
    """``np.unique(vs)`` (int64) for vertex ids in ``[0, n)``, by marking
    them: O(n + len(vs)) where the sort is O(len(vs) log len(vs)), and the
    neighbour lists of a BFS level on a power-law graph run to tens of
    millions of entries."""
    mark = np.zeros(n, dtype=bool)
    mark[vs] = True
    return np.flatnonzero(mark)


def _neighbors_of(row_ptr: np.ndarray, col: np.ndarray, vs: np.ndarray) -> np.ndarray:
    counts = row_ptr[vs + 1] - row_ptr[vs]
    total = int(counts.sum())
    if total == 0:
        return np.array([], dtype=np.int64)
    out = np.empty(total, dtype=np.int64)
    offs = np.zeros(vs.size + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    # vectorized multi-range gather
    idx = np.repeat(row_ptr[vs] - offs[:-1], counts) + np.arange(total)
    out[:] = col[idx]
    return out


def _refine_once(g: Graph, part: np.ndarray, k: int, cap: int) -> np.ndarray:
    """Move boundary vertices to the neighbor-majority partition if balance
    permits.  One vectorized sweep (conflicts resolved by processing order)."""
    part = part.copy()
    # per-vertex edge counts toward each partition: sparse accumulate
    # find boundary vertices first
    src_p, dst_p = part[g.src], part[g.dst]
    boundary = _distinct_vertices(g.src[src_p != dst_p], g.n_vertices)
    if boundary.size == 0:
        return part
    if boundary.size > 20_000:  # cap the host-side sweep on huge graphs
        boundary = boundary[:: boundary.size // 20_000 + 1]
    sizes = np.bincount(part, minlength=k).astype(np.int64)
    row_ptr, col, _ = g.csr
    # process a sample of boundary vertices (cheap sweep)
    for v in boundary:
        nbrs = col[row_ptr[v] : row_ptr[v + 1]]
        if nbrs.size == 0:
            continue
        votes = np.bincount(part[nbrs], minlength=k)
        best = int(np.argmax(votes))
        cur = int(part[v])
        if best != cur and votes[best] > votes[cur] and sizes[best] < cap:
            part[v] = best
            sizes[best] += 1
            sizes[cur] -= 1
    return part
