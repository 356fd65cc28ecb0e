"""Carry the system's "weights" across from numpy: the graph, its partition
and the carried traversal state.

Everything here takes plain numpy arrays (never an object of the JAX
package), so a graph built anywhere -- by ``repro``, by a loader, by a test
-- becomes the port's ``PartitionedGraph`` with the same bytes, and a window
state pulled to the host resumes on the port's engine.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.structs import Graph, PartitionedGraph
from repro_torch.graph.traversal import WindowState


def partitioned_graph_from_numpy(
    n_vertices: int,
    src: np.ndarray,
    dst: np.ndarray,
    weights: np.ndarray | None,
    n_parts: int,
    part_of_vertex: np.ndarray,
) -> PartitionedGraph:
    """The port's ``PartitionedGraph`` over the given edge list and vertex
    -> partition map (copied, with the dtypes the containers require)."""
    g = Graph(
        int(n_vertices),
        np.array(src, dtype=np.int32),
        np.array(dst, dtype=np.int32),
        None if weights is None else np.array(weights, dtype=np.float32),
    )
    return PartitionedGraph(g, int(n_parts), np.array(part_of_vertex, dtype=np.int32))


def window_state_from_numpy(
    state: np.ndarray, frontier: np.ndarray, n_supersteps: np.ndarray, device
) -> WindowState:
    """A ``WindowState`` on ``device`` from host arrays ``[S, n]`` state
    (float32 or int32), ``[S, n]`` bool frontier and ``[S]`` int32 steps."""
    state = np.array(state)  # a writable copy: torch shares the buffer
    if state.dtype not in (np.float32, np.int32):
        raise TypeError(f"state must be float32 or int32, got {state.dtype}")
    frontier = np.array(frontier, dtype=bool)
    nst = np.array(n_supersteps, dtype=np.int32)
    if state.ndim != 2 or frontier.shape != state.shape or nst.shape != state.shape[:1]:
        raise ValueError(
            f"shapes must be [S, n], [S, n], [S]; got {state.shape}, "
            f"{frontier.shape}, {nst.shape}"
        )
    device = torch.device(device)
    return WindowState(
        torch.as_tensor(state, device=device),
        torch.as_tensor(frontier, device=device),
        torch.as_tensor(nst, device=device),
    )
