"""Metagraph sketch and a-priori algorithm modeling (paper s3.2).

A metagraph has one meta-vertex per subgraph (WCC within a partition),
attributed with its local vertex/edge counts, and meta-edges weighted by the
number of remote edges between subgraph pairs.  For a BFS/SSSP launched at a
source vertex, a BFS over the metagraph predicts -- before running anything on
the large graph --

  * the superstep at which each subgraph is *first* visited
    (= meta-hop distance from the source subgraph), and
  * the supersteps at which it *may be revisited* (any walk length at which
    the meta-vertex is reachable again: a longer meta-path can deliver a
    remote message that re-activates an already-visited subgraph).

Combined with the linear cost model (alpha * vertices + beta * edges) this
yields a *predicted* TimeFunction usable for launch-time planning, which the
placement strategies consume exactly like a measured trace.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.timing import DEFAULT_ALPHA, DEFAULT_BETA, TimeFunction
from repro_torch.graph.structs import PartitionedGraph


@dataclasses.dataclass(frozen=True)
class Metagraph:
    n_meta: int
    part_of_meta: np.ndarray  # [S] partition owning each meta-vertex
    n_vertices: np.ndarray  # [S] local vertices per subgraph
    n_local_edges: np.ndarray  # [S] local edges per subgraph
    msrc: np.ndarray  # [ME] meta-edge source subgraph ids (directed, dedup)
    mdst: np.ndarray  # [ME] meta-edge dest subgraph ids
    mweight: np.ndarray  # [ME] remote-edge multiplicity

    @property
    def n_meta_edges(self) -> int:
        return int(self.msrc.shape[0])

    def adjacency(self) -> list[np.ndarray]:
        """Out-neighbor list per meta-vertex (host-side, metagraphs are tiny)."""
        order = np.argsort(self.msrc, kind="stable")
        srcs = self.msrc[order]
        dsts = self.mdst[order]
        bounds = np.searchsorted(srcs, np.arange(self.n_meta + 1))
        return [dsts[bounds[i] : bounds[i + 1]] for i in range(self.n_meta)]


def build_metagraph(pg: PartitionedGraph) -> Metagraph:
    sg = pg.subgraph_of_vertex
    g = pg.graph
    nv, ne = pg.subgraph_sizes
    remote = ~pg.is_local_edge
    ms, md = sg[g.src[remote]], sg[g.dst[remote]]
    # dedup directed meta-edges, accumulate weight
    key = ms.astype(np.int64) * pg.n_subgraphs + md
    uniq, inv = np.unique(key, return_inverse=True)
    weight = np.bincount(inv, minlength=uniq.shape[0])
    msrc = (uniq // pg.n_subgraphs).astype(np.int64)
    mdst = (uniq % pg.n_subgraphs).astype(np.int64)
    return Metagraph(
        n_meta=pg.n_subgraphs,
        part_of_meta=pg.part_of_subgraph.astype(np.int64),
        n_vertices=nv,
        n_local_edges=ne,
        msrc=msrc,
        mdst=mdst,
        mweight=weight.astype(np.int64),
    )


def meta_bfs_levels(mg: Metagraph, source_meta: int) -> np.ndarray:
    """First-visit superstep per meta-vertex (1-based; 0 = unreached)."""
    level = np.zeros(mg.n_meta, dtype=np.int64)
    level[source_meta] = 1
    adj = mg.adjacency()
    frontier = [source_meta]
    d = 1
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if level[v] == 0:
                    level[v] = d
                    nxt.append(int(v))
        frontier = nxt
    return level


def reachable_at_length(mg: Metagraph, source_meta: int, max_len: int) -> np.ndarray:
    """[max_len+1, S] bool: walk of length L exists from source to meta-vertex."""
    out = np.zeros((max_len + 1, mg.n_meta), dtype=bool)
    out[0, source_meta] = True
    for ell in range(1, max_len + 1):
        prev = out[ell - 1]
        active = prev[mg.msrc]
        np.logical_or.at(out[ell], mg.mdst[active], True)
    return out


@dataclasses.dataclass(frozen=True)
class PredictedSchedule:
    """A-priori activation plan: which subgraphs run at which superstep."""

    first_visit: np.ndarray  # [S] 1-based superstep of first visit (0 = never)
    active: np.ndarray  # [m, S] bool: subgraph (re)active at superstep
    n_supersteps: int


def predict_schedule(
    mg: Metagraph, source_meta: int, *, revisit_horizon: float = 1.5
) -> PredictedSchedule:
    """First visits are exact (= meta-hop distance, validated in tests);
    revisits are heuristic: subgraph sg may be re-activated at superstep s if
    a meta-walk of length s-1 reaches it after its first visit.  Walks exist
    for every length in a cyclic metagraph, so the prediction horizon is
    capped at ``ceil(revisit_horizon * max_first_visit)`` supersteps -- the
    paper's own revisit model is likewise approximate ("may be revisited")."""
    level = meta_bfs_levels(mg, source_meta)
    depth = int(level.max())
    m = max(depth, int(np.ceil(revisit_horizon * depth)))
    reach = reachable_at_length(mg, source_meta, m)
    active = np.zeros((m, mg.n_meta), dtype=bool)
    for s in range(1, m + 1):
        # first visit at s, or a potential revisit: reachable again by a walk
        # of length s-1 (message arrives at boundary s-1 -> s) after first visit
        first = level == s
        revisit = (level > 0) & (level < s) & reach[s - 1]
        active[s - 1] = first | revisit
    return PredictedSchedule(first_visit=level, active=active, n_supersteps=m)


def predict_time_function(
    pg: PartitionedGraph,
    source_vertex: int,
    *,
    mg: Metagraph | None = None,
    alpha: float = DEFAULT_ALPHA,
    beta: float = DEFAULT_BETA,
    revisit_fraction: float = 0.25,
    revisit_horizon: float = 1.5,
) -> tuple[TimeFunction, PredictedSchedule]:
    """A-priori TimeFunction for a BFS/SSSP from ``source_vertex``.

    First visits cost the full local-traversal estimate
    ``alpha*nv + beta*ne``; predicted revisits cost ``revisit_fraction`` of it
    (a revisit re-traverses only the improved region).
    """
    if mg is None:
        mg = build_metagraph(pg)
    source_meta = int(pg.subgraph_of_vertex[source_vertex])
    sched = predict_schedule(mg, source_meta, revisit_horizon=revisit_horizon)
    full_cost = alpha * mg.n_vertices + beta * mg.n_local_edges
    m = sched.n_supersteps
    tau = np.zeros((m, pg.n_parts), dtype=np.float64)
    for s in range(m):
        act = sched.active[s]
        first = sched.first_visit == (s + 1)
        cost = np.where(first, full_cost, revisit_fraction * full_cost) * act
        np.add.at(tau[s], mg.part_of_meta, cost)
    return TimeFunction(tau), sched
