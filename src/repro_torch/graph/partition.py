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

Host-side numpy, byte-identical to ``repro.graph.partition`` (the dense
parts; the mesh layout arrives with the multi-GPU engine).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structs import (
    CsrEdgeLayout,
    Graph,
    PartitionedGraph,
    dst_sorted_layout,
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
            nbrs = np.unique(nbrs)
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
    frontier = np.array([source], dtype=np.int64)
    d = 0
    while frontier.size:
        d += 1
        nbrs = _neighbors_of(row_ptr, col, frontier)
        nbrs = np.unique(nbrs[~np.isfinite(dist[nbrs])])
        dist[nbrs] = d
        frontier = nbrs
    return dist


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
    boundary = np.unique(g.src[src_p != dst_p])
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
