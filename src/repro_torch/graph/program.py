"""VertexProgram algebra: one engine API for BFS, SSSP, WCC, and PageRank.

The port of ``repro.graph.program``: the same static spec (``reduce``,
``stationary``, ``plane_key``, ``superstep_budget``, dtype and identity) and
the same host-side ``init``/``edge_plane`` hooks, with the per-edge and
per-vertex methods written as torch ops on tensors.

A program is defined by:

  * ``relax(msg, w)``   -- the per-edge transform applied to the source
    vertex's state value along an edge carrying plane value ``w``
    (BFS/SSSP: ``msg + w``; WCC: ``msg``; PageRank: ``msg * w``),
  * ``combine(a, b)`` with ``identity`` -- the commutative, associative
    reduction used for every aggregation point; ``reduce`` names it
    ("min" or "sum") so the relax kernel can be specialized on it,
  * ``is_active(new, old)`` -- the frontier predicate of monotone programs
    (a vertex whose state strictly improved joins the next frontier),
  * ``apply(state, acc, n)`` + ``keep_running(n_steps)`` -- the stationary
    alternative: one gather pass per superstep, a per-vertex update applied
    at the superstep boundary, and a fixed iteration budget standing in for
    the frontier,
  * ``dtype`` / ``init`` -- the state spec: numpy element type (the torch
    twin is ``torch_dtype``), identity padding value, and the initial
    ``(state, frontier)`` in global vertex order,
  * ``edge_plane`` -- an optional per-edge value plane replacing the graph's
    weights (BFS forces unit hops; PageRank uses ``1/out_degree[src]``).

Monotone programs (``stationary=False``) run the local closure to fixpoint
and need ``reduce == "min"``; stationary programs run one gather pass per
superstep until ``superstep_budget`` is spent.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.structs import PartitionedGraph

#: numpy state dtype -> torch dtype (the only state types the algebra uses)
_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch twin of a program's numpy state dtype."""
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except KeyError:
        raise ValueError(f"unsupported state dtype {np.dtype(dtype)}") from None


class VertexProgram:
    """Base class of the vertex-program algebra (see module docstring).

      name              program id (also the engine-cache key head)
      reduce            "min" | "sum": the combine op the relax reduction
                        is specialized on
      stationary        False: monotone closure shape; True: one-pass shape
      plane_key         cache key of the edge-weight plane this program reads
      superstep_budget  stationary only: exact supersteps to run
    """

    name = "vertex-program"
    reduce = "min"
    stationary = False
    plane_key = "graph"
    superstep_budget: int | None = None

    # -- state spec ----------------------------------------------------------

    @property
    def dtype(self):
        """numpy dtype of the per-vertex state."""
        return np.float32

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def identity(self):
        """Identity element of ``combine`` (also the padding value)."""
        if self.reduce == "min":
            if np.issubdtype(self.dtype, np.floating):
                return self.dtype(np.inf)
            return self.dtype(np.iinfo(self.dtype).max)
        return self.dtype(0)

    @property
    def key(self) -> tuple:
        """Hashable engine-cache key (override for parameterized programs)."""
        return (self.name,)

    def collective_signature(self, *, mirrored: bool = False) -> dict:
        """Declared collective footprint of ONE superstep of the mesh window
        program (the JAX package's contract; ``graph.mesh_exchange`` records
        every window's collectives and holds them against it).

        ``all_to_all`` value exchange rounds at the superstep boundary (two
        under hub mirroring), ``psum`` value psums inside the superstep body,
        ``pmax_boundary`` scalar syncs at the boundary and ``pmax_closure``
        syncs per local-closure iteration (monotone only).
        """
        a2a = 2 if mirrored else 1
        if self.stationary:
            return {"all_to_all": a2a, "psum": 0, "pmax_boundary": 2, "pmax_closure": 0}
        return {"all_to_all": a2a, "psum": 0, "pmax_boundary": 1, "pmax_closure": 2}

    # -- the algebra (torch ops) ---------------------------------------------

    def relax(self, msg: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Per-edge transform of the source state value ``msg`` along an edge
        with plane value ``w``.  Must map ``identity`` to ``identity``."""
        raise NotImplementedError

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Commutative, associative reduction matching ``reduce``."""
        return torch.minimum(a, b) if self.reduce == "min" else a + b

    def is_active(self, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        """Monotone frontier predicate: min-programs strictly decrease."""
        return new < old

    def apply(self, state: torch.Tensor, acc: torch.Tensor, n_vertices: int):
        """Stationary per-superstep update: fold the ``combine``-accumulated
        incoming messages ``acc`` into the state (once per superstep)."""
        raise NotImplementedError

    def keep_running(self, n_steps: torch.Tensor) -> torch.Tensor:
        """Stationary frontier: ``[S]`` bool, True while under budget."""
        return n_steps < self.superstep_budget

    # -- host-side hooks -----------------------------------------------------

    def converged(self, frontier_any: bool) -> bool:
        """Host-side convergence test for ``TraversalEngine.run``."""
        return not frontier_any

    def init(
        self, pg: PartitionedGraph, sources: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Initial ``(state, frontier)``, both ``[S, n]`` numpy arrays in
        global vertex order."""
        raise NotImplementedError

    def initial_active_parts(
        self, pg: PartitionedGraph, sources: np.ndarray
    ) -> np.ndarray:
        """[P] bool: partitions active at superstep 0."""
        _, frontier = self.init(pg, np.atleast_1d(np.asarray(sources)))
        active = np.zeros(pg.n_parts, dtype=bool)
        active[pg.part_of_vertex[np.flatnonzero(frontier.any(axis=0))]] = True
        return active

    def edge_plane(self, pg: PartitionedGraph) -> np.ndarray | None:
        """Per-edge ``[E]`` float32 value plane in *original* edge order, or
        None to read the graph's weights (unit by default)."""
        return None


def resolve_edge_plane(
    pg: PartitionedGraph, program: VertexProgram
) -> np.ndarray | None:
    """The program's validated ``[E]`` float32 plane in original edge order,
    or None when ``plane_key == "graph"`` (read the layout's own weights)."""
    if program.plane_key == "graph":
        return None
    plane = np.asarray(program.edge_plane(pg), dtype=np.float32)
    if plane.shape != (pg.graph.n_edges,):
        raise ValueError(
            f"{program.name}: edge_plane must be [{pg.graph.n_edges}], "
            f"got {plane.shape}"
        )
    return plane


def validate_program(program: VertexProgram) -> VertexProgram:
    """Engine-entry validation of a program's static spec."""
    if program.reduce not in ("min", "sum"):
        raise ValueError(f"{program.name}: reduce must be 'min' or 'sum'")
    if not program.stationary and program.reduce != "min":
        raise NotImplementedError(
            f"{program.name}: the monotone local-closure loop needs an "
            "idempotent combine (reduce='min'); sum-style programs must set "
            "stationary=True"
        )
    if program.stationary:
        budget = program.superstep_budget
        if budget is None or int(budget) < 1:
            raise ValueError(
                f"{program.name}: stationary programs need a positive "
                f"superstep_budget, got {budget!r}"
            )
    torch_dtype(program.dtype)  # raises on a state type the port lacks
    return program


#: keys every ``collective_signature()`` must declare
SIGNATURE_KEYS = ("all_to_all", "psum", "pmax_boundary", "pmax_closure")


def validate_collective_signature(
    program: VertexProgram, *, mirrored: bool = False
) -> dict:
    """Validate and return the program's declared collective signature.

    Called by the mesh engine at construction, which then holds every
    window's recorded collectives against it, so a malformed declaration
    fails loudly rather than silently passing an empty expectation.
    ``mirrored`` selects the hub-mirroring variant of the declaration (one
    extra ``all_to_all`` for the mirror->owner sync).
    """
    sig = dict(program.collective_signature(mirrored=mirrored))
    missing = [k for k in SIGNATURE_KEYS if k not in sig]
    extra = [k for k in sig if k not in SIGNATURE_KEYS]
    if missing or extra:
        raise ValueError(
            f"{program.name}: collective_signature() must declare exactly "
            f"{SIGNATURE_KEYS}; missing {missing}, unexpected {extra}"
        )
    for k, v in sig.items():
        if not isinstance(v, int) or v < 0:
            raise ValueError(
                f"{program.name}: collective_signature()[{k!r}] must be a "
                f"non-negative int, got {v!r}"
            )
    return sig


def _source_init(
    pg: PartitionedGraph, sources: np.ndarray, identity, dtype
) -> tuple[np.ndarray, np.ndarray]:
    """(state=identity except 0 at each row's source, one-hot frontier)."""
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    s_batch = sources.shape[0]
    state = np.full((s_batch, pg.graph.n_vertices), identity, dtype=dtype)
    state[np.arange(s_batch), sources] = 0
    frontier = np.zeros((s_batch, pg.graph.n_vertices), dtype=bool)
    frontier[np.arange(s_batch), sources] = True
    return state, frontier


class SsspProgram(VertexProgram):
    """Weighted single-source shortest paths (min-plus semiring); on a
    unit-weight graph this *is* BFS.  The engine default."""

    name = "sssp"
    reduce = "min"
    plane_key = "graph"

    def relax(self, msg, w):
        return msg + w

    def init(self, pg, sources):
        return _source_init(pg, sources, np.inf, self.dtype)


class BfsProgram(SsspProgram):
    """Unweighted BFS: hop counts regardless of the graph's weight plane."""

    name = "bfs"
    plane_key = "unit"

    def edge_plane(self, pg):
        return np.ones(pg.graph.n_edges, dtype=np.float32)


class WccProgram(VertexProgram):
    """Weakly-connected components by min label propagation (int32 labels).

    Every vertex starts active with its own id as the label; on the
    symmetrized generator graphs the fixpoint labels each vertex with the
    smallest vertex id in its weakly-connected component.
    """

    name = "wcc"
    reduce = "min"
    plane_key = "graph"  # plane values are ignored by relax

    @property
    def dtype(self):
        return np.int32

    def relax(self, msg, w):
        del w
        return msg

    def init(self, pg, sources):
        sources = np.atleast_1d(np.asarray(sources))
        s_batch = sources.shape[0]
        n = pg.graph.n_vertices
        state = np.tile(np.arange(n, dtype=self.dtype), (s_batch, 1))
        frontier = np.ones((s_batch, n), dtype=bool)
        return state, frontier


class PageRankProgram(VertexProgram):
    """Stationary PageRank: sum-times semiring, fixed iteration budget.

    Per superstep every vertex recomputes
    ``(1 - damping)/n + damping * sum_{u -> v} rank[u] / out_degree[u]``;
    the per-edge contribution rides the ``1/out_degree[src]`` edge plane so
    ``relax`` is a multiply and the reduction a sum.
    """

    name = "pagerank"
    reduce = "sum"
    stationary = True
    plane_key = "invdeg"

    def __init__(self, damping: float = 0.85, num_iters: int = 20):
        if not 0.0 < damping < 1.0:
            raise ValueError(f"damping must lie in (0, 1), got {damping}")
        self.damping = float(damping)
        self.superstep_budget = int(num_iters)

    @property
    def key(self):
        return (self.name, self.damping, self.superstep_budget)

    def relax(self, msg, w):
        return msg * w

    def apply(self, state, acc, n_vertices: int):
        # Python floats against a float32 tensor stay float32, as JAX's weak
        # types do; the rounding may still differ in the last bit
        return (1.0 - self.damping) / n_vertices + self.damping * acc

    def init(self, pg, sources):
        sources = np.atleast_1d(np.asarray(sources))
        s_batch = sources.shape[0]
        n = pg.graph.n_vertices
        state = np.full((s_batch, n), 1.0 / n, dtype=self.dtype)
        frontier = np.ones((s_batch, n), dtype=bool)
        return state, frontier

    def edge_plane(self, pg):
        deg = np.maximum(pg.graph.out_degree, 1).astype(np.float32)
        return (1.0 / deg)[pg.graph.src]


#: registry for CLI / bench sweeps (constructors, not instances: PageRank is
#: parameterized and instances carry the engine-cache key)
BUILTIN_PROGRAMS = {
    "bfs": BfsProgram,
    "sssp": SsspProgram,
    "wcc": WccProgram,
    "pagerank": PageRankProgram,
}
