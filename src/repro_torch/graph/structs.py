"""Graph containers.

A ``Graph`` is a directed edge list over ``n_vertices`` (undirected graphs are
stored symmetrized).  A ``PartitionedGraph`` adds a vertex->partition map and
the subgraph (weakly-connected-component-within-partition) labeling that the
paper's metagraph is built from.

Construction is host-side numpy; the BSP/traversal layers consume the arrays
as torch tensors on the engine's device.  This is the port's own copy of
``repro.graph.structs`` (dense-engine parts only): the port never imports the
JAX package.
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
    the CUDA relax kernel walks (one warp per ``(source, vertex)``) in place
    of the TPU kernel's block map."""
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


def dst_sorted_layout(
    n_vertices: int,
    src: np.ndarray,
    dst: np.ndarray,
    weights: np.ndarray | None = None,
) -> CsrEdgeLayout:
    """Build the static dst-sorted layout for an edge set (host-side, once)."""
    order = np.argsort(dst, kind="stable")
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
        order = np.argsort(self.src, kind="stable")
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
