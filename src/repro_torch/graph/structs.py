"""Graph containers.

A ``Graph`` is a directed edge list over ``n_vertices`` (undirected graphs are
stored symmetrized).  A ``PartitionedGraph`` adds a vertex->partition map and
the subgraph (weakly-connected-component-within-partition) labeling that the
paper's metagraph is built from.

Construction is host-side numpy; the BSP/traversal layers consume the arrays
as torch tensors on the engine's device.  This is the port's own copy of
``repro.graph.structs``: the port never imports the JAX package.  The mesh
layout's TPU block maps give way to per-plane CSR offsets
(``MeshEdgeLayout.row_ptr``), the relax kernel's indexing.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from functools import cached_property

import numpy as np

INF_DIST = np.float32(np.inf)

#: Bound on every side cache kept on a graph or layout instance (block
#: maps per geometry, device copies per device, engines per knob set): a run
#: touches one or two keys of each, so a small LRU never thrashes while
#: still bounding pathological sweeps.
_SIDE_CACHE_MAX = 8


class BoundedCache(OrderedDict):
    """LRU-bounded side cache: at most ``max_entries`` live entries.

    The repo-wide cache discipline: every long-lived dict cache must be
    bounded, and its keys must be *coerced* scalars/tuples (``int(...)``,
    ``str(...)``) so dtype or type aliases of the same value hit one entry
    instead of growing the cache.
    """

    def __init__(self, max_entries: int, *args):
        super().__init__(*args)
        self.max_entries = int(max_entries)

    def put(self, key, value):
        """Insert ``key`` as most-recently-used and evict past the bound."""
        self[key] = value
        self.move_to_end(key)
        while len(self) > self.max_entries:
            self.popitem(last=False)
        return value

    def get_or_build(self, key, build):
        """Return the cached value for ``key``, building (and bounding) on miss."""
        if key in self:
            self.move_to_end(key)
            return self[key]
        return self.put(key, build())


def side_cache(owner, name: str) -> BoundedCache:
    """The bounded side cache ``name`` kept in ``owner.__dict__`` (frozen
    dataclass instances included), created on first use."""
    cache = owner.__dict__.get(name)
    if not isinstance(cache, BoundedCache):
        cache = owner.__dict__[name] = BoundedCache(_SIDE_CACHE_MAX)
    return cache


def block_ranges_for(
    dst: np.ndarray, n: int, block_n: int, block_e: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-row-block contiguous edge-block span for an ascending ``dst``
    array: (start [NB], count [NB], t_max).

    Because ``dst`` is sorted, the set of edge blocks intersecting a row
    block ``[ob*block_n, (ob+1)*block_n)`` is a contiguous range of edge
    blocks -- representable as a start index and a count, which is what the
    block-skipping relax kernel scalar-prefetches.  ``t_max = max(count)``
    bounds the kernel's inner grid dimension (vs ``ceil(E/block_e)`` for a
    dense grid that tests intersection per tile).  The Hopper kernel walks
    ``row_ptr_for`` spans instead; the block map stays as the layout
    contract the port is checked against.
    """
    dst = np.asarray(dst)
    e = int(dst.shape[0])
    nb = max(1, -(-n // block_n))
    if e == 0:
        return np.zeros(nb, np.int32), np.zeros(nb, np.int32), 1
    neb = -(-e // block_e)
    firsts = dst[np.arange(neb) * block_e]
    lasts = dst[np.minimum(np.arange(1, neb + 1) * block_e, e) - 1]
    lo = firsts // block_n  # first row block each edge block touches
    hi = lasts // block_n  # last row block each edge block touches
    rows = np.arange(nb)
    start = np.searchsorted(hi, rows, side="left").astype(np.int32)
    end = np.searchsorted(lo, rows, side="right").astype(np.int32)
    count = np.maximum(end - start, 0).astype(np.int32)
    return start, count, max(1, int(count.max()))


def row_ptr_for(dst: np.ndarray, n: int) -> np.ndarray:
    """``[n + 1]`` int32 CSR offsets of an ascending ``dst``: the edges that
    land on vertex ``v`` are ``[row_ptr[v], row_ptr[v + 1])``.  This is what
    the CUDA relax kernel splits by merge path in place of the TPU kernel's
    block map."""
    dst = np.asarray(dst)
    if dst.shape[0] >= 2**31:
        raise ValueError(f"{dst.shape[0]} edges overflow int32 row offsets")
    return np.searchsorted(dst, np.arange(n + 1), side="left").astype(np.int32)


@dataclasses.dataclass(frozen=True)
class CsrEdgeLayout:
    """Static destination-sorted edge layout, built once per (sub)edge-set.

    The traversal engine and the ``bfs_relax`` kernel consume edges in this
    fixed order for the lifetime of a graph, which (a) lets every segment
    reduction take the ``indices_are_sorted`` fast path, (b) kills the
    per-call ``argsort`` the kernel wrapper used to pay, and (c) makes the
    per-tile destination ranges *static*, so the kernel grid can skip
    (row_block, edge_block) tiles that provably hold no in-range edge.

    Contract: ``dst`` is ascending; ``src``/``weights`` are permuted to match.
    ``perm`` retains the applied permutation (indices into the edge arrays the
    layout was built from) so per-program *edge-weight planes* -- alternative
    ``[E]`` value arrays such as PageRank's ``1/out_degree[src]`` -- can be
    permuted into layout order without re-sorting (``graph.program``).
    """

    n_vertices: int
    src: np.ndarray  # [E] int32, reordered by dst
    dst: np.ndarray  # [E] int32, ascending
    weights: np.ndarray  # [E] float32, reordered by dst
    perm: np.ndarray | None = None  # [E] int64 indices into the input order

    @property
    def n_edges(self) -> int:
        return int(self.dst.shape[0])

    def block_ranges(self, block_n: int, block_e: int) -> tuple[np.ndarray, np.ndarray, int]:
        """Per-row-block contiguous edge-block span: (start [NB], count [NB], t_max).

        Because ``dst`` is sorted, the set of edge blocks intersecting a row
        block ``[ob*block_n, (ob+1)*block_n)`` is a contiguous range of edge
        blocks -- representable as a start index and a count, which is what
        the block-skipping kernel scalar-prefetches.  ``t_max = max(count)``
        bounds the kernel's inner grid dimension (vs ``ceil(E/block_e)`` for
        the dense grid that tests intersection per tile).
        """
        key = ("block_ranges", int(block_n), int(block_e))
        return side_cache(self, "_block_cache").get_or_build(
            key,
            lambda: block_ranges_for(self.dst, self.n_vertices, int(block_n), int(block_e)),
        )


def stable_argsort(keys: np.ndarray, n_keys: int) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` (int64) for integer keys in
    ``[0, n_keys)``.  Each key packed above its position is unique, so
    numpy's fastest (unstable) sort orders the packed values the same way,
    and the positions read back from the low bits are the stable order --
    several times faster than the stable sort on tens of millions of keys.
    """
    e = int(keys.shape[0])
    bits = max(1, e.bit_length())
    if int(n_keys).bit_length() + bits > 63:
        return np.argsort(keys, kind="stable")
    packed = np.left_shift(keys.astype(np.int64), bits)
    packed |= np.arange(e, dtype=np.int64)
    packed.sort()
    packed &= (1 << bits) - 1
    return packed


def sorted_distinct(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` by a sort and a scan of run boundaries.  numpy 2.3
    may answer ``np.unique`` from a hash table, which on tens of millions of
    distinct int64 keys is far slower than the sort."""
    a = np.sort(a)
    if a.size < 2:
        return a
    keep = np.empty(a.size, dtype=bool)
    keep[0] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


def dst_sorted_layout(
    n_vertices: int,
    src: np.ndarray,
    dst: np.ndarray,
    weights: np.ndarray | None = None,
) -> CsrEdgeLayout:
    """Build the static dst-sorted layout for an edge set (host-side, once)."""
    order = stable_argsort(dst, n_vertices)
    w = (
        np.ones(src.shape[0], dtype=np.float32)
        if weights is None
        else weights.astype(np.float32)
    )
    return CsrEdgeLayout(
        n_vertices=n_vertices,
        src=src[order].astype(np.int32),
        dst=dst[order].astype(np.int32),
        weights=w[order],
        perm=order.astype(np.int64),
    )


def mesh_layout_key(
    device_of_part: np.ndarray, n_devices: int, generation: int = 0
) -> tuple:
    """Canonical cache key of a mesh layout: ``n_devices`` plus the *coerced*
    partition -> device map's shape, dtype, and bytes, plus the graph's
    edge-delta ``generation``.

    Computed after the int32 coercion every consumer goes through, so callers
    passing the same placement with different dtypes (an int64 plan row vs an
    int32 stored map) hit one entry.  ``generation`` is the streaming-mutation
    counter (``PartitionedGraph.__dict__['_delta_generation']``, bumped by
    ``graph.deltas``): two layouts of the same placement built before and
    after a delta merge carry different edge content under identical shapes,
    so the generation is part of every key derived from this one.
    """
    coerced = np.ascontiguousarray(device_of_part, dtype=np.int32)
    return (
        int(n_devices), coerced.shape, coerced.dtype.str, coerced.tobytes(),
        int(generation),
    )


#: the per-device reduction planes of a mesh layout (``MeshEdgeLayout.plane``)
MESH_PLANES = ("local", "wire", "mirror")


@dataclasses.dataclass(frozen=True)
class MeshEdgeLayout:
    """Static mesh-aware extension of ``CsrEdgeLayout`` (one per device map).

    Extends the partitioned dst-sorted layout to a fixed assignment of
    partitions onto ``n_devices`` mesh ranks so that every rank's shard is a
    *fixed-shape* slice and every collective has a *static* payload:

      * vertices are permuted device-major and padded to ``n_pad`` rows per
        device (``pos_of_vertex``/``vertex_of_pos``); a rank's carried
        traversal state is its ``[S, n_pad]`` block of the ``[S, D * n_pad]``
        device-major axis,
      * local (within-partition) edges are grouped per owning device and
        padded to ``e_local_pad``, endpoints renumbered to device-local rows
        (both endpoints of a local edge share a device because a partition is
        never split across devices),
      * remote (cross-partition) edges are grouped by
        ``(src_device, dst_device)`` block; within each block the *distinct*
        destination vertices define static wire slots (``w_pad`` slots per
        block), so the superstep-boundary exchange aggregates per-destination
        **before** the collective -- one message per
        ``(dst_vertex, dst_device)``, not one per edge -- and the all-to-all
        payload is the fixed ``[n_devices, w_pad]`` buffer,
      * optionally (``mirror_degree`` is not None), *hub* destinations --
        vertices whose cross-partition in-degree meets the threshold -- are
        pulled out of the wire plane into a structurally identical *mirror*
        plane: every source device holds one mirror slot per
        ``(owner_device, hub)`` it sends into (``m_pad`` slots per block),
        and a second all-to-all syncs each mirror to its owner once per
        superstep (``graph.mesh_exchange`` has the exactness argument).

    All index arrays carry explicit validity masks; padded entries are wired
    to contribute identity values (``inf`` under min, ``0`` under sum).  Built
    host-side once per ``(PartitionedGraph, device_of_part)`` by
    ``partition.mesh_edge_layout``, field for field the JAX package's layout.

    ``l_eid``/``r_eid`` map every per-device edge slot back to its row in the
    partition layout's dst-sorted local/remote edge sets, so a per-program
    edge-weight plane can be scattered into the padded per-device shape
    without rebuilding the layout.  The layout is also the single owner of the
    *state indexing* helpers (``state_index_of_vertex`` / ``gather_global``).
    """

    n_devices: int
    n_vertices: int
    n_parts: int
    device_of_part: np.ndarray  # [P] int32 owning device per partition
    # -- vertex shard views --------------------------------------------------
    n_pad: int  # padded vertex rows per device
    pos_of_vertex: np.ndarray  # [n] int64: device-major padded position
    vertex_of_pos: np.ndarray  # [D * n_pad] int64, -1 on padding rows
    part_of_pos: np.ndarray  # [D, n_pad] int32 (0 on padding; masked by valid)
    pos_valid: np.ndarray  # [D, n_pad] bool
    # -- per-device local edges (device-local dst ascending) -----------------
    e_local_pad: int
    lsrc: np.ndarray  # [D, e_local_pad] int32 device-local src row
    ldst: np.ndarray  # [D, e_local_pad] int32 device-local dst row, ascending
    lw: np.ndarray  # [D, e_local_pad] float32
    lpart: np.ndarray  # [D, e_local_pad] int32 partition of each edge
    lvalid: np.ndarray  # [D, e_local_pad] bool
    l_eid: np.ndarray  # [D, e_local_pad] int64 row in the dst-sorted local set
    # -- per-device remote out-edges, (dst_device, dst_vertex)-sorted --------
    e_remote_pad: int
    w_pad: int  # wire slots per (src_device, dst_device) block
    rsrc: np.ndarray  # [D, e_remote_pad] int32 device-local src row
    rw: np.ndarray  # [D, e_remote_pad] float32
    rslot: np.ndarray  # [D, e_remote_pad] int32 in [0, D*w_pad), ascending
    rpart: np.ndarray  # [D, e_remote_pad] int32 src partition of each edge
    rvalid: np.ndarray  # [D, e_remote_pad] bool
    r_eid: np.ndarray  # [D, e_remote_pad] int64 row in the dst-sorted remote set
    # -- receive side: wire slot -> device-local dst row ---------------------
    recv_idx: np.ndarray  # [D_recv, D_send, w_pad] int32 (0 on padding slots)
    # -- static exchange metadata (bench / diagnostics) ----------------------
    wire_slots: np.ndarray  # [D_send, D_recv] int64 distinct-dst slot counts
    remote_block_edges: np.ndarray  # [D_send, D_recv] int64 raw edge counts
    # -- hub mirroring (zero-width when mirror_degree selects no hubs) -------
    mirror_degree: int | None = None  # threshold the layout was built with
    e_mirror_pad: int = 0  # padded hub edges per source device
    m_pad: int = 0  # mirror slots per (src_device, owner_device) block
    msrc: np.ndarray | None = None  # [D, e_mirror_pad] int32 device-local src
    mw: np.ndarray | None = None  # [D, e_mirror_pad] float32
    mslot: np.ndarray | None = None  # [D, e_mirror_pad] int32 in [0, D*m_pad)
    mpart: np.ndarray | None = None  # [D, e_mirror_pad] int32 src partition
    mvalid: np.ndarray | None = None  # [D, e_mirror_pad] bool
    m_eid: np.ndarray | None = None  # [D, e_mirror_pad] int64 remote-set row
    mrecv_idx: np.ndarray | None = None  # [D_recv, D_send, m_pad] int32
    mirror_slots: np.ndarray | None = None  # [D_send, D_recv] int64 hub slots
    mirror_block_edges: np.ndarray | None = None  # [D_send, D_recv] int64
    # -- streaming mutations -------------------------------------------------
    delta_generation: int = 0  # graph's edge-delta counter at build time

    @property
    def state_width(self) -> int:
        """Width of the device-major state axis: ``n_devices * n_pad``."""
        return self.n_devices * self.n_pad

    @property
    def layout_key(self) -> tuple:
        """This layout's canonical cache key (``mesh_layout_key`` of its own
        map and delta generation plus the mirror knob)."""
        return mesh_layout_key(
            self.device_of_part, self.n_devices, self.delta_generation
        ) + (self.mirror_degree,)

    # -- shared state indexing -----------------------------------------------

    @property
    def state_index_of_vertex(self) -> np.ndarray:
        """[n] position of each global vertex in the device-major state axis."""
        return self.pos_of_vertex

    def gather_global(self, state_rows: np.ndarray) -> np.ndarray:
        """Map device-major state ``[..., D * n_pad]`` back to global vertex
        order ``[..., n]``."""
        return np.asarray(state_rows)[..., self.pos_of_vertex]

    # -- per-device CSR offsets (the relax kernel's indexing) ----------------
    #
    # Each rank's reduction problem is the kernel's shape: ``ldst[d]`` is
    # ascending over ``n_pad`` device-local rows (pad value ``n_pad - 1``),
    # ``rslot[d]`` over ``n_devices * w_pad`` wire slots (pad value
    # ``D * w_pad - 1``) and ``mslot[d]`` over ``n_devices * m_pad`` mirror
    # slots.  Padded edges point at real rows but carry identity candidates,
    # so they are reduction no-ops.

    def plane(self, kind: str, d: int) -> tuple[np.ndarray, int, int]:
        """``(rows [e_pad] ascending, n_segments, n_valid_edges)`` of one
        rank's ``kind`` plane (``"local"``, ``"wire"`` or ``"mirror"``)."""
        if kind == "local":
            rows, nseg, valid = self.ldst[d], self.n_pad, self.lvalid[d]
        elif kind == "wire":
            rows, nseg, valid = self.rslot[d], self.n_devices * self.w_pad, self.rvalid[d]
        elif kind == "mirror":
            rows, nseg, valid = self.mslot[d], self.n_devices * self.m_pad, self.mvalid[d]
        else:
            raise ValueError(f"plane must be one of {MESH_PLANES}, got {kind!r}")
        return rows, int(nseg), int(np.count_nonzero(valid))

    def row_ptr(self, kind: str, d: int) -> np.ndarray:
        """``[n_segments + 1]`` int32 CSR offsets of rank ``d``'s ``kind``
        plane, cached per ``(kind, d)``."""
        rows, nseg, _ = self.plane(kind, d)
        return side_cache(self, "_row_ptr_cache").get_or_build(
            (str(kind), int(d)), lambda: row_ptr_for(rows, nseg)
        )


#: the per-rank rows of a ``MeshEdgeLayout`` that a ``MeshRankLayout`` keeps
#: (its ``[D, ...]`` fields at index ``rank``); the per-edge partition ids
#: (``lpart``/``rpart``/``mpart``) are not kept: the engine never reads them
MESH_RANK_ROWS = (
    "part_of_pos", "pos_valid",
    "lsrc", "ldst", "lw", "lvalid", "l_eid",
    "rsrc", "rw", "rslot", "rvalid", "r_eid", "recv_idx",
    "msrc", "mw", "mslot", "mvalid", "m_eid", "mrecv_idx",
)


@dataclasses.dataclass(frozen=True)
class MeshRankLayout:
    """One rank's block of a ``MeshEdgeLayout``: what a mesh rank computes
    on, built by ``partition.mesh_rank_layout`` without the other ranks'
    planes.

    Every ``MESH_RANK_ROWS`` field is the full layout's row ``rank``
    (``recv_idx``/``mrecv_idx``: ``[D_send, pad]``, the slots this rank
    receives); ``vertex_of_pos`` is the rank's ``[n_pad]`` slice.  The
    global parts are kept whole: the vertex permutation ``pos_of_vertex``
    (``[n]``, the state indexing every rank shares) and the ``[D, D]``
    block counts that fix ``w_pad``/``m_pad`` (gathered from every rank).
    """

    rank: int
    n_devices: int
    n_vertices: int
    n_parts: int
    device_of_part: np.ndarray  # [P] int32
    n_pad: int
    pos_of_vertex: np.ndarray  # [n] int64, global
    vertex_of_pos: np.ndarray  # [n_pad] int64, -1 on padding rows
    part_of_pos: np.ndarray  # [n_pad] int32
    pos_valid: np.ndarray  # [n_pad] bool
    e_local_pad: int
    lsrc: np.ndarray  # [e_local_pad] int32
    ldst: np.ndarray  # [e_local_pad] int32 ascending
    lw: np.ndarray  # [e_local_pad] float32
    lvalid: np.ndarray  # [e_local_pad] bool
    l_eid: np.ndarray  # [e_local_pad] int64
    e_remote_pad: int
    w_pad: int
    rsrc: np.ndarray  # [e_remote_pad] int32
    rw: np.ndarray  # [e_remote_pad] float32
    rslot: np.ndarray  # [e_remote_pad] int32 ascending
    rvalid: np.ndarray  # [e_remote_pad] bool
    r_eid: np.ndarray  # [e_remote_pad] int64
    recv_idx: np.ndarray  # [D_send, w_pad] int32
    wire_slots: np.ndarray  # [D_send, D_recv] int64
    remote_block_edges: np.ndarray  # [D_send, D_recv] int64
    mirror_degree: int | None
    e_mirror_pad: int
    m_pad: int
    msrc: np.ndarray  # [e_mirror_pad] int32
    mw: np.ndarray  # [e_mirror_pad] float32
    mslot: np.ndarray  # [e_mirror_pad] int32 ascending
    mvalid: np.ndarray  # [e_mirror_pad] bool
    m_eid: np.ndarray  # [e_mirror_pad] int64
    mrecv_idx: np.ndarray  # [D_send, m_pad] int32
    mirror_slots: np.ndarray  # [D_send, D_recv] int64
    mirror_block_edges: np.ndarray  # [D_send, D_recv] int64
    delta_generation: int = 0

    @classmethod
    def of(cls, ml: MeshEdgeLayout, rank: int) -> "MeshRankLayout":
        """Rank ``rank``'s block of a full layout (views, no copies)."""
        r = int(rank)
        rows = {f: getattr(ml, f)[r] for f in MESH_RANK_ROWS}
        whole = {
            f.name: getattr(ml, f.name)
            for f in dataclasses.fields(cls)
            if f.name not in rows and f.name not in ("rank", "vertex_of_pos")
        }
        return cls(
            rank=r, vertex_of_pos=ml.vertex_of_pos[r * ml.n_pad:(r + 1) * ml.n_pad],
            **rows, **whole,
        )

    state_width = MeshEdgeLayout.state_width
    layout_key = MeshEdgeLayout.layout_key
    state_index_of_vertex = MeshEdgeLayout.state_index_of_vertex
    gather_global = MeshEdgeLayout.gather_global

    def plane(self, kind: str, d: int | None = None) -> tuple[np.ndarray, int, int]:
        """``(rows [e_pad] ascending, n_segments, n_valid_edges)`` of this
        rank's ``kind`` plane (``MeshEdgeLayout.plane``)."""
        self._own(d)
        if kind == "local":
            rows, nseg, valid = self.ldst, self.n_pad, self.lvalid
        elif kind == "wire":
            rows, nseg, valid = self.rslot, self.n_devices * self.w_pad, self.rvalid
        elif kind == "mirror":
            rows, nseg, valid = self.mslot, self.n_devices * self.m_pad, self.mvalid
        else:
            raise ValueError(f"plane must be one of {MESH_PLANES}, got {kind!r}")
        return rows, int(nseg), int(np.count_nonzero(valid))

    def row_ptr(self, kind: str, d: int | None = None) -> np.ndarray:
        """``[n_segments + 1]`` int32 CSR offsets of this rank's ``kind``
        plane, cached per kind."""
        rows, nseg, _ = self.plane(kind, d)
        return side_cache(self, "_row_ptr_cache").get_or_build(
            str(kind), lambda: row_ptr_for(rows, nseg)
        )

    def _own(self, d) -> None:
        if d is not None and int(d) != self.rank:
            raise ValueError(f"rank {self.rank}'s layout holds no plane of rank {d}")


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed graph as an edge list. ``weights`` default to 1.0 (BFS)."""

    n_vertices: int
    src: np.ndarray  # [E] int32
    dst: np.ndarray  # [E] int32
    weights: np.ndarray | None = None  # [E] float32 or None (unit weights)

    def __post_init__(self):
        assert self.src.dtype == np.int32 and self.dst.dtype == np.int32
        assert self.src.shape == self.dst.shape

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @cached_property
    def edge_weights(self) -> np.ndarray:
        if self.weights is not None:
            return self.weights.astype(np.float32)
        return np.ones(self.n_edges, dtype=np.float32)

    @cached_property
    def csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(row_ptr [n+1], col_idx [E], edge_id [E]) sorted by src."""
        order = stable_argsort(self.src, self.n_vertices)
        col = self.dst[order]
        counts = np.bincount(self.src, minlength=self.n_vertices)
        row_ptr = np.zeros(self.n_vertices + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return row_ptr, col, order.astype(np.int64)

    @cached_property
    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_vertices).astype(np.int64)

    def symmetrized(self) -> "Graph":
        """Return graph with both edge directions present (deduplicated)."""
        s = np.concatenate([self.src, self.dst])
        d = np.concatenate([self.dst, self.src])
        w = None
        if self.weights is not None:
            w = np.concatenate([self.weights, self.weights])
        key = s.astype(np.int64) * self.n_vertices + d
        if w is None:
            # the distinct keys alone give src and dst (no first-occurrence
            # index to find, which costs a stable sort)
            key = sorted_distinct(key)
            return Graph(
                self.n_vertices,
                (key // self.n_vertices).astype(np.int32),
                (key % self.n_vertices).astype(np.int32),
            )
        _, idx = np.unique(key, return_index=True)
        return Graph(
            self.n_vertices,
            s[idx].astype(np.int32),
            d[idx].astype(np.int32),
            None if w is None else w[idx].astype(np.float32),
        )


def _label_propagation_components(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Connected-component labels via vectorized min-label propagation.

    Treats edges as undirected.  Converges in O(component diameter) sweeps;
    each sweep is two ``np.minimum.at`` scatters, so large low-diameter graphs
    converge in a handful of passes.
    """
    labels = np.arange(n, dtype=np.int64)
    while True:
        prev = labels.copy()
        # propagate min label across edges both directions
        np.minimum.at(labels, dst, labels[src])
        np.minimum.at(labels, src, labels[dst])
        # pointer jumping: labels point at representative labels
        labels = labels[labels]
        if np.array_equal(labels, prev):
            break
    # compact to 0..k-1
    _, compact = np.unique(labels, return_inverse=True)
    return compact.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """A Graph plus a vertex partition map and derived subgraph labeling.

    Terms follow the paper (s3.1):
      * ``part_of_vertex[v]``     -- partition id in [0, n_parts)
      * local edge                -- src and dst in same partition
      * remote edge               -- crosses partitions
      * subgraph                  -- WCC of the local-edge graph within one
                                     partition; ``subgraph_of_vertex[v]`` is a
                                     globally unique subgraph id
    """

    graph: Graph
    n_parts: int
    part_of_vertex: np.ndarray  # [n] int32

    def __post_init__(self):
        assert self.part_of_vertex.shape == (self.graph.n_vertices,)

    # -- edge classification ------------------------------------------------
    @cached_property
    def edge_src_part(self) -> np.ndarray:
        return self.part_of_vertex[self.graph.src]

    @cached_property
    def edge_dst_part(self) -> np.ndarray:
        return self.part_of_vertex[self.graph.dst]

    @cached_property
    def is_local_edge(self) -> np.ndarray:
        return self.edge_src_part == self.edge_dst_part

    @property
    def n_local_edges(self) -> int:
        return int(self.is_local_edge.sum())

    @property
    def n_remote_edges(self) -> int:
        return self.graph.n_edges - self.n_local_edges

    @property
    def edge_cut_fraction(self) -> float:
        return self.n_remote_edges / max(1, self.graph.n_edges)

    # -- subgraphs (WCCs within partitions) ---------------------------------
    @cached_property
    def subgraph_of_vertex(self) -> np.ndarray:
        """Globally-unique subgraph id per vertex.

        Computed as WCC over local edges only, then components that span a
        partition are (by construction) impossible, so each component lies in
        exactly one partition.
        """
        local = self.is_local_edge
        comp = _label_propagation_components(
            self.graph.n_vertices, self.graph.src[local], self.graph.dst[local]
        )
        # Vertices in different partitions must never share a subgraph id even
        # if they were isolated (comp would still separate them since no local
        # edge joins partitions) -- comp is already correct; just compact.
        return comp

    @property
    def n_subgraphs(self) -> int:
        return int(self.subgraph_of_vertex.max()) + 1

    @cached_property
    def part_of_subgraph(self) -> np.ndarray:
        """[n_subgraphs] partition owning each subgraph."""
        out = np.zeros(self.n_subgraphs, dtype=np.int32)
        out[self.subgraph_of_vertex] = self.part_of_vertex
        return out

    @cached_property
    def subgraph_sizes(self) -> tuple[np.ndarray, np.ndarray]:
        """(n_vertices [S], n_local_edges [S]) per subgraph."""
        nv = np.bincount(self.subgraph_of_vertex, minlength=self.n_subgraphs)
        sg_src = self.subgraph_of_vertex[self.graph.src]
        local = self.is_local_edge
        ne = np.bincount(sg_src[local], minlength=self.n_subgraphs)
        return nv.astype(np.int64), ne.astype(np.int64)

    @cached_property
    def partition_sizes(self) -> tuple[np.ndarray, np.ndarray]:
        """(n_vertices [P], n_local_edges [P]) per partition."""
        nv = np.bincount(self.part_of_vertex, minlength=self.n_parts)
        ne = np.bincount(self.edge_src_part[self.is_local_edge], minlength=self.n_parts)
        return nv.astype(np.int64), ne.astype(np.int64)

    def partition_bytes(self, bytes_per_vertex: int = 16, bytes_per_edge: int = 8) -> np.ndarray:
        """Approximate serialized size per partition, for data-movement cost."""
        nv, ne = self.partition_sizes
        return nv * bytes_per_vertex + ne * bytes_per_edge

    def balance_factor(self) -> float:
        """max partition vertex count / mean (paper uses METIS load factor 1.03)."""
        nv, _ = self.partition_sizes
        return float(nv.max() / max(1.0, nv.mean()))
