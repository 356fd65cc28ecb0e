"""Graph substrate of the port (see ``repro_torch`` and ``repro.graph``).

  structs     -- PartitionedGraph, WCC subgraph labeling, the dst-sorted
                 CsrEdgeLayout and its block map / CSR row offsets
  generators  -- synthetic graphs matched to the paper's dataset families
  partition   -- hash + BFS-grow partitioners and the local/remote layout
  config      -- ``EngineConfig`` (device, backend, depth, window)
  program     -- the VertexProgram algebra as torch ops
  traversal   -- the dense device-resident BSP engine and the
                 one-superstep oracle ``make_superstep_fn``
  bsp         -- host drivers building BSP work traces
  deltas      -- streaming edge mutations: bounded ``EdgeDeltaBuffer``
                 merged into a new graph at window boundaries (dense half)
  session     -- ``open_session(pg, config)``: the unified facade over
                 engines, windowed traversal, delta merges and the executor

``TraversalResult.asdict()``, ``ExecutionReport.asdict()`` and
``ServiceReport.asdict()`` return the JAX package's schema-versioned dict
shape (``graph.config.versioned_report``): consumers key on field names.
"""

from repro_torch.graph.config import REPORT_SCHEMA_VERSION, EngineConfig
from repro_torch.graph.generators import (
    erdos_renyi_graph,
    rmat_graph,
    road_grid_graph,
    weighted,
)
from repro_torch.graph.partition import (
    bfs_grow_partition,
    contiguous_device_map,
    hash_partition,
)
from repro_torch.graph.program import (
    BUILTIN_PROGRAMS,
    BfsProgram,
    PageRankProgram,
    SsspProgram,
    VertexProgram,
    WccProgram,
)
from repro_torch.graph.structs import Graph, PartitionedGraph
from repro_torch.graph.deltas import EdgeDeltaBuffer, apply_delta_buffer
from repro_torch.graph.session import GraphSession, open_session

__all__ = [
    "Graph",
    "PartitionedGraph",
    "rmat_graph",
    "road_grid_graph",
    "erdos_renyi_graph",
    "weighted",
    "hash_partition",
    "bfs_grow_partition",
    "contiguous_device_map",
    "VertexProgram",
    "BfsProgram",
    "SsspProgram",
    "WccProgram",
    "PageRankProgram",
    "BUILTIN_PROGRAMS",
    "EngineConfig",
    "REPORT_SCHEMA_VERSION",
    "EdgeDeltaBuffer",
    "apply_delta_buffer",
    "GraphSession",
    "open_session",
]
