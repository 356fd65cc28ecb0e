"""BSP driver: runs the subgraph-centric traversal to global convergence and
collects the execution trace that instantiates the paper's time function A.

The drivers here are thin host-side adapters over
``traversal.TraversalEngine``: the whole traversal (inner closure loop,
remote exchange, counter accumulation) runs device-resident to convergence,
and the trace materializes from one bulk device->host transfer of the
results per traversal batch (the engine's loop conditions are the only
other host reads; ``TraversalEngine.host_syncs`` counts them).

Partition activity is derived from the device-side work counters
(``verts_processed > 0`` -- a partition is active iff it held frontier
vertices at superstep start, which is exactly what the first inner-closure
iteration counts), and active-subgraph sets from a device segment-any over
``subgraph_of_vertex`` -- not from host-side ``np.unique`` over a pulled
frontier.

Knobs: ``max_supersteps`` doubles as the device trace-buffer depth
(``m_max``); ``run_bc_forward`` batches all sources into one ``[S, n]``
traversal so compilation and per-superstep kernels amortize across sources.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.config import EngineConfig
from repro_torch.graph.program import VertexProgram
from repro_torch.graph.structs import PartitionedGraph
from repro_torch.graph.traversal import TraversalResult, get_engine


@dataclasses.dataclass
class BSPTrace:
    """Per-(superstep, partition) work counters from a BSP execution.

    ``active[s, p]`` is True when partition p had frontier vertices at the
    start of superstep s (its subgraphs' compute() ran).  ``edges``/``verts``
    are the work counters used to derive tau via the calibrated cost model.
    """

    active: np.ndarray  # [m, P] bool
    edges_examined: np.ndarray  # [m, P] int64
    verts_processed: np.ndarray  # [m, P] int64
    msgs_sent: np.ndarray  # [m, P] int64
    inner_iters: np.ndarray  # [m] int64
    active_subgraphs: list[np.ndarray]  # per superstep: global subgraph ids

    @property
    def n_supersteps(self) -> int:
        return self.active.shape[0]

    @property
    def n_parts(self) -> int:
        return self.active.shape[1]

    def mean_active_fraction(self) -> float:
        """The paper's Fig 2 utilization proxy: mean fraction of partitions
        active per superstep."""
        return float(self.active.mean())


def _trace_of_source(res: TraversalResult, s: int, collect_subgraphs: bool) -> BSPTrace:
    """Slice source ``s``'s trimmed trace out of a batched TraversalResult."""
    m = int(res.n_supersteps[s])
    verts = res.verts_processed[s, :m].astype(np.int64)
    sg_sets: list[np.ndarray] = []
    if collect_subgraphs:
        sg_sets = [
            np.flatnonzero(res.sg_active[s, i]).astype(np.int64) for i in range(m)
        ]
    return BSPTrace(
        active=verts > 0,
        edges_examined=res.edges_examined[s, :m].astype(np.int64),
        verts_processed=verts,
        msgs_sent=res.msgs_sent[s, :m].astype(np.int64),
        inner_iters=res.inner_iters[s, :m].astype(np.int64),
        active_subgraphs=sg_sets,
    )


def run_sssp(
    pg: PartitionedGraph,
    source: int,
    *,
    max_supersteps: int = 4096,
    collect_subgraphs: bool = True,
    config: EngineConfig | None = None,
) -> tuple[np.ndarray, BSPTrace]:
    """Run subgraph-centric BFS/SSSP from ``source``; return distances + trace.

    BFS is the ``weights=None`` special case (unit weights).  ``config``
    (an ``EngineConfig``) threads the device/backend knobs through to the
    engine; ``max_supersteps``/``collect_subgraphs`` override its fields.
    """
    cfg = (config or EngineConfig()).replace(
        m_max=max_supersteps, collect_subgraphs=collect_subgraphs
    )
    engine = get_engine(pg, config=cfg)
    res = engine.run([source])
    return res.dist[0], _trace_of_source(res, 0, collect_subgraphs)


def run_program(
    pg: PartitionedGraph,
    program: VertexProgram,
    sources=(0,),
    *,
    max_supersteps: int = 4096,
    collect_subgraphs: bool = False,
    config: EngineConfig | None = None,
) -> tuple[np.ndarray, list[BSPTrace]]:
    """Run any ``VertexProgram`` on the device-resident engine.

    Returns the final per-vertex values ``[S, n]`` and one trimmed
    ``BSPTrace`` per batch row.  For source-free programs (WCC, PageRank)
    ``sources`` only sizes the batch; a single row is the common case.
    """
    sources = list(sources)  # materialize once: iterators must not re-drain
    cfg = (config or EngineConfig()).replace(
        m_max=max_supersteps, collect_subgraphs=collect_subgraphs
    )
    engine = get_engine(pg, program=program, config=cfg)
    res = engine.run(sources)
    traces = [
        _trace_of_source(res, s, collect_subgraphs)
        for s in range(len(sources))
    ]
    return res.dist, traces


def concat_traces(traces: list[BSPTrace]) -> BSPTrace:
    """Concatenate supersteps of consecutive traversals into one job trace."""
    return BSPTrace(
        active=np.concatenate([t.active for t in traces]),
        edges_examined=np.concatenate([t.edges_examined for t in traces]),
        verts_processed=np.concatenate([t.verts_processed for t in traces]),
        msgs_sent=np.concatenate([t.msgs_sent for t in traces]),
        inner_iters=np.concatenate([t.inner_iters for t in traces]),
        active_subgraphs=[s for t in traces for s in t.active_subgraphs],
    )


def run_bc_forward(
    pg: PartitionedGraph,
    sources: list[int],
    *,
    max_supersteps: int = 4096,
    config: EngineConfig | None = None,
) -> BSPTrace:
    """Betweenness-centrality forward phase (paper s7 future work): one BFS
    sweep per source, executed as consecutive waves.  The per-wave rise and
    fall of the active set is the 'sinusoidal' activation of the paper's
    ref [15] that elastic placement exploits between waves.

    All sources run as one batched ``[S, n]`` device-resident traversal (one
    compile, one kernel sequence, one bulk transfer); the returned trace is
    the per-source traces concatenated in wave order, identical in shape and
    semantics to running the waves serially.
    """
    cfg = (config or EngineConfig()).replace(
        m_max=max_supersteps, collect_subgraphs=False
    )
    engine = get_engine(pg, config=cfg)
    res = engine.run(list(sources))
    return concat_traces(
        [_trace_of_source(res, s, False) for s in range(len(sources))]
    )
