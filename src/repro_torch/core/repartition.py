"""Spinner-style incremental repartitioning at window boundaries.

The port's copy of ``repro.core.repartition``: host-side numpy, unchanged.

Streaming mutations drift the partition quality the planner's cost model was
calibrated against: inserts biased across partition boundaries inflate the
remote plane, which is exactly the term a mesh exchange pays for (one wire
slot per distinct ``(src_device, dst_vertex)`` under mirroring, one message
per remote edge without).  Rather than re-running a full partitioner -- which
would invalidate every layout and move unbounded state -- this module adapts
the existing map the way Spinner (arXiv 1404.3861) adapts label propagation:
a *bounded* number of boundary vertices migrate per window boundary toward
the partition their neighborhood votes for, each move accepted only if it
strictly lowers an explicit penalty.

**Penalty** (``partition_penalty``): the partition-granular image of the wire
model.  A cross-partition edge into a non-hub destination costs 1 (one wire
message); cross edges into a *hub* (cross in-degree >= ``mirror_degree``,
the same predicate as the JAX package's ``partition._mirror_hub_plan``)
cost one slot per
distinct ``(src_part, hub)`` pair -- mirroring collapses a hub's fan-in to
one mirror sync per sending side, so fan-in beyond the first edge is free.
With ``mirror_degree=None`` the penalty is the plain edge cut.

**Mover** (``incremental_repartition``): boundary vertices ordered by cross
degree; each candidate proposes its neighbor-majority partition and the move
is re-scored with an exact O(E) penalty recompute -- no stale incremental
bookkeeping -- under a balance cap.  Only strict improvements commit, so the
penalty is monotonically non-increasing by construction (the convergence
property the tests pin), and at most ``max_moves`` vertices migrate per call,
bounding both layout churn and carried-state movement.

The result carries fresh per-partition size/activity stats
(``RepartitionResult.part_activity``, in the planner's ``alpha * vertices +
beta * edges`` tau units) so ``OnlineReplanner.reprime`` can replace the
stale construction-time metagraph sketch -- closing the mutate ->
re-partition -> re-plan loop.  A moved map yields a *new*
``PartitionedGraph`` with a bumped ``_delta_generation``: partition moves
change every plane, so nothing cached against the old map may survive.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.timing import DEFAULT_ALPHA, DEFAULT_BETA
from repro_torch.graph.structs import Graph, PartitionedGraph


@dataclasses.dataclass(frozen=True)
class RepartitionConfig:
    """Knobs of one bounded repartition pass."""

    max_moves: int = 64  # accepted migrations per window boundary
    max_candidates: int | None = None  # scored boundary vertices (4x moves)
    balance: float = 1.10  # vertex-count cap, x mean partition size
    mirror_degree: int | None = None  # hub threshold the penalty prices


@dataclasses.dataclass(frozen=True)
class RepartitionResult:
    """Outcome of one pass plus the fresh stats the replanner re-primes on."""

    pg: PartitionedGraph  # post-move graph (input instance when moves == 0)
    moves: int
    penalty_before: float
    penalty_after: float  # <= penalty_before, always
    part_sizes: np.ndarray  # [P] int64 vertices per partition
    part_edges: np.ndarray  # [P] int64 local edges per partition
    part_activity: np.ndarray  # [P] float64 tau-unit activity prior


def partition_penalty(
    g: Graph,
    part_of_vertex: np.ndarray,
    *,
    mirror_degree: int | None = None,
) -> float:
    """Mirror-aware communication penalty of a partition map.

    Cross edges into non-hubs count individually; cross edges into hubs
    count once per distinct ``(src_part, hub_vertex)`` pair.  Hub status is
    recomputed from the map itself (cross in-degree), matching
    ``_mirror_hub_plan`` on the resulting ``PartitionedGraph`` exactly.
    """
    part = np.asarray(part_of_vertex)
    src_p = part[g.src]
    dst_p = part[g.dst]
    cross = src_p != dst_p
    if mirror_degree is None:
        return float(np.count_nonzero(cross))
    indeg = np.bincount(g.dst[cross], minlength=g.n_vertices)
    hub = indeg[g.dst] >= int(mirror_degree)
    ch = cross & hub
    n_wire = int(np.count_nonzero(cross & ~hub))
    pair_key = src_p[ch].astype(np.int64) * g.n_vertices + g.dst[ch]
    return float(n_wire + np.unique(pair_key).size)


def incremental_repartition(
    pg: PartitionedGraph,
    *,
    config: RepartitionConfig | None = None,
) -> RepartitionResult:
    """One bounded LPA pass over the boundary vertices of ``pg``.

    Pure host-side numpy; never mutates ``pg``.  See the module docstring
    for the accept rule; the monotone-penalty invariant is structural (only
    strictly improving moves commit).
    """
    cfg = config or RepartitionConfig()
    g = pg.graph
    n = g.n_vertices
    k = pg.n_parts
    part = pg.part_of_vertex.astype(np.int32).copy()
    cap = int(np.ceil(cfg.balance * n / k))
    sizes = np.bincount(part, minlength=k)

    penalty = partition_penalty(g, part, mirror_degree=cfg.mirror_degree)
    before = penalty

    src_p = part[g.src]
    dst_p = part[g.dst]
    cross = src_p != dst_p
    cross_deg = np.bincount(g.src[cross], minlength=n) + np.bincount(
        g.dst[cross], minlength=n
    )
    boundary = np.flatnonzero(cross_deg > 0)
    n_cand = (
        4 * cfg.max_moves if cfg.max_candidates is None else cfg.max_candidates
    )
    order = boundary[np.argsort(-cross_deg[boundary], kind="stable")][:n_cand]

    row_ptr, col, _ = g.csr
    moves = 0
    for v in order:
        if moves >= cfg.max_moves:
            break
        nbrs = col[row_ptr[v]:row_ptr[v + 1]]
        if nbrs.size == 0:
            continue
        votes = np.bincount(part[nbrs], minlength=k)
        best = int(np.argmax(votes))
        cur = int(part[v])
        if best == cur or votes[best] <= votes[cur]:
            continue
        if sizes[best] + 1 > cap:
            continue
        part[v] = best
        trial = partition_penalty(g, part, mirror_degree=cfg.mirror_degree)
        if trial < penalty:
            penalty = trial
            sizes[cur] -= 1
            sizes[best] += 1
            moves += 1
        else:
            part[v] = cur

    if moves == 0:
        out_pg = pg
    else:
        out_pg = PartitionedGraph(g, k, part)
        out_pg.__dict__["_delta_generation"] = (
            int(pg.__dict__.get("_delta_generation", 0)) + 1
        )
    nv, ne = out_pg.partition_sizes
    activity = (DEFAULT_ALPHA * nv + DEFAULT_BETA * ne).astype(np.float64)
    return RepartitionResult(
        pg=out_pg,
        moves=moves,
        penalty_before=before,
        penalty_after=penalty,
        part_sizes=nv,
        part_edges=ne,
        part_activity=activity,
    )
