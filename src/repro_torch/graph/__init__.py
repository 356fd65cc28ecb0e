"""Graph substrate of the port (see ``repro_torch`` and ``repro.graph``).

  structs     -- PartitionedGraph, WCC subgraph labeling, the dst-sorted
                 CsrEdgeLayout and its block map / CSR row offsets
  generators  -- synthetic graphs matched to the paper's dataset families
  partition   -- hash + BFS-grow partitioners and the local/remote layout
  config      -- ``EngineConfig`` (device, backend, depth)
  program     -- the VertexProgram algebra as torch ops
  traversal   -- the dense device-resident BSP engine
  bsp         -- host drivers building BSP work traces
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
]
