"""The dense subgraph-centric BSP engine in PyTorch, parameterized by a
VertexProgram.

Semantics follow GoFFish (paper s3.1) and the JAX package's
``repro.graph.traversal`` exactly: within a BSP superstep every *active*
subgraph runs its local traversal to closure over **local** edges (a loop of
frontier-masked edge relaxations); at the superstep boundary remote edges
deliver messages, and vertices improved by a remote message form the next
superstep's frontier.  The engine accumulates the per-partition *work
counters* ``[S, m_max, P]`` (vertices processed, edges examined, messages
sent) that instantiate the paper's time function A.  Monotone programs (BFS,
weighted SSSP, WCC) run the local closure to fixpoint; stationary programs
(PageRank) run one gather pass per superstep and fold the accumulated
messages with ``program.apply`` until the iteration budget is spent.

Every value reduction -- the local closure and the remote exchange --
goes through ``kernels.bfs_relax.ops.make_relax_fn``: the hand-written CUDA
kernel on a card (``backend="cuda"``, the default there), the plain
``scatter_reduce_`` version on the CPU (``backend="torch"``).  Candidate
gathers, counters and frontier logic are torch ops under both backends, so
counters and superstep counts are identical across them.

The work counters are computed per vertex, not per edge: the local edges a
frontier vertex examines are its local out-degree, so ``edges_examined`` is
the per-partition sum of ``frontier * local_out_degree`` -- the same integers
the JAX package's per-edge ``segment_sum`` gives, from an ``[S, n]`` pass in
place of an ``[S, E]`` one.  Per-partition sums are an exact int64 prefix
sum over vertices grouped by partition (no atomics).

Host syncs.  The JAX package runs a whole window as one jitted
``lax.while_loop``.  In eager torch the superstep condition and the inner
closure condition each read one boolean back to the host per iteration;
``TraversalEngine.host_syncs`` counts them (plus the final pull), so a run
can report what that costs.  Capturing the loop in a CUDA graph is later
work.

``run`` executes one batched traversal of depth ``m_max`` and returns numpy
leaves; ``init_state`` / ``run_window`` run it resumably, leaving the
carried state on the device between windows; ``backfill_rows`` swaps batch
rows at a window boundary.  ``state_index_of_vertex``, ``gather_global``
and ``device_of_part`` are the state-layout accessors the elastic executor
and the session read (identity and ``None`` here: the dense engine keeps
state in global vertex order on one device).  ``make_superstep_fn`` is the
one-superstep equivalence oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graph.config import EngineConfig, resolve_device, versioned_report
from repro_torch.graph.partition import partitioned_edge_layout
from repro_torch.graph.program import (
    SsspProgram,
    VertexProgram,
    resolve_edge_plane,
    validate_program,
)
from repro_torch.graph.structs import PartitionedGraph, side_cache
from repro_torch.kernels.bfs_relax.ops import make_relax_fn, validate_backend

def _pg_cached(pg: PartitionedGraph, name: str, key: tuple, build):
    """Fetch-or-build ``key`` in the bounded side cache ``name`` of ``pg``
    (device arrays keyed by the coerced device string, engines by the
    coerced knobs)."""
    return side_cache(pg, name).get_or_build(key, build)


class _DeviceArrays(NamedTuple):
    """Device copies of the static per-graph arrays, uploaded once per
    ``(graph, device)`` and shared by every engine built on it."""

    lsrc: torch.Tensor  # [E_local] int32 src of each dst-sorted local edge
    lw: torch.Tensor  # [E_local] float32 graph weights
    rsrc: torch.Tensor  # [E_remote] int32
    rw: torch.Tensor  # [E_remote] float32
    ldeg: torch.Tensor  # [n] int64 local out-degree per vertex
    rdeg: torch.Tensor  # [n] int64 remote out-degree per vertex
    part_order: torch.Tensor  # [n] int64 vertices grouped by partition
    part_bounds: torch.Tensor  # [P + 1] int64 group offsets into part_order


def _device_arrays(pg: PartitionedGraph, device: torch.device) -> _DeviceArrays:
    def build():
        layout = partitioned_edge_layout(pg)
        n = pg.graph.n_vertices
        vpart = pg.part_of_vertex.astype(np.int64)
        bounds = np.zeros(pg.n_parts + 1, dtype=np.int64)
        np.cumsum(np.bincount(vpart, minlength=pg.n_parts), out=bounds[1:])
        host = _DeviceArrays(
            lsrc=layout.local.src,
            lw=layout.local.weights,
            rsrc=layout.remote.src,
            rw=layout.remote.weights,
            ldeg=np.bincount(layout.local.src, minlength=n).astype(np.int64),
            rdeg=np.bincount(layout.remote.src, minlength=n).astype(np.int64),
            part_order=np.argsort(vpart, kind="stable").astype(np.int64),
            part_bounds=bounds,
        )
        return _DeviceArrays(*(torch.as_tensor(a, device=device) for a in host))

    return _pg_cached(pg, "_traversal_device_arrays", (str(device),), build)


def plane_arrays(pg: PartitionedGraph, program: VertexProgram, device):
    """Per-program ``(local, remote)`` edge-plane tensors on ``device`` in
    the static layout's edge order, cached on the graph by
    ``(program.plane_key, device)``.

    ``plane_key == "graph"`` reuses the layout's own weights; anything else
    asks the program for an ``[E]`` plane in original edge order and
    permutes it through the layout's retained sort permutation.
    """
    device = torch.device(device)
    if program.plane_key == "graph":
        dev = _device_arrays(pg, device)
        return dev.lw, dev.rw

    def build():
        plane = resolve_edge_plane(pg, program)  # O(E); only on cache miss
        layout = partitioned_edge_layout(pg)
        return (
            torch.as_tensor(plane[layout.local_eid], device=device),
            torch.as_tensor(plane[layout.remote_eid], device=device),
        )

    return _pg_cached(
        pg, "_plane_device_arrays", (str(program.plane_key), str(device)), build
    )


def _part_sums(x: torch.Tensor, dev: _DeviceArrays) -> torch.Tensor:
    """``[R, n]`` integer/bool per-vertex values -> ``[R, P]`` int32 sums per
    partition, exact: an int64 prefix sum over partition-grouped vertices."""
    cs = torch.cumsum(x.index_select(1, dev.part_order).to(torch.int64), dim=1)
    cs = torch.nn.functional.pad(cs, (1, 0))
    at = cs.index_select(1, dev.part_bounds)
    return (at[:, 1:] - at[:, :-1]).to(torch.int32)


class SuperstepResult(NamedTuple):
    dist: torch.Tensor  # [n] float32, updated distances
    next_frontier: torch.Tensor  # [n] bool, vertices improved by remote messages
    edges_examined: torch.Tensor  # [P] int32, local edges scanned this superstep
    verts_processed: torch.Tensor  # [P] int32, frontier vertices processed
    msgs_sent: torch.Tensor  # [P] int32, remote messages emitted per src partition
    inner_iters: torch.Tensor  # [] int32, local-closure iterations


def make_superstep_fn(pg: PartitionedGraph, *, config: EngineConfig | None = None):
    """The one-superstep SSSP function over ``pg`` on ``config.device``:
    ``(dist [n], frontier [n]) -> SuperstepResult``, the host loop outside.

    The equivalence oracle of the JAX package's ``make_superstep_fn``: the
    local closure to fixpoint, then the remote exchange, with per-edge
    counters.  It is written apart from the engine's window program -- its
    reductions are ``scatter_reduce`` and ``index_add_`` over every edge,
    never the relax kernel nor the engine's per-vertex counters -- so the
    engine can be held against it.
    """
    device = resolve_device((config or EngineConfig()).device)
    layout = partitioned_edge_layout(pg)
    n, n_parts = pg.graph.n_vertices, pg.n_parts

    def on_device(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    i64 = torch.int64
    lsrc, ldst = on_device(layout.local.src, i64), on_device(layout.local.dst, i64)
    rsrc, rdst = on_device(layout.remote.src, i64), on_device(layout.remote.dst, i64)
    lw = on_device(layout.local.weights, torch.float32)
    rw = on_device(layout.remote.weights, torch.float32)
    lpart, rpart = on_device(layout.local_part, i64), on_device(layout.remote_src_part, i64)
    vpart = on_device(pg.part_of_vertex, i64)

    def seg_min(base, dst, cand):
        return base.scatter_reduce(0, dst, cand, reduce="amin", include_self=True)

    def seg_count(mask, part):
        zeros = torch.zeros(n_parts, dtype=torch.int32, device=device)
        return zeros.index_add_(0, part, mask.to(torch.int32))

    def superstep(dist: torch.Tensor, frontier: torch.Tensor) -> SuperstepResult:
        d, fr, touched = dist, frontier, frontier
        we = torch.zeros(n_parts, dtype=torch.int32, device=device)
        wv = torch.zeros_like(we)
        iters = 0
        while bool(fr.any()):
            active_e = fr[lsrc]
            new_d = seg_min(d, ldst, torch.where(active_e, d[lsrc] + lw, torch.inf))
            improved = new_d < d
            we = we + seg_count(active_e, lpart)
            wv = wv + seg_count(fr, vpart)
            d, fr, touched, iters = new_d, improved, touched | improved, iters + 1
        # -- remote exchange at the superstep boundary ----------------------
        active_e = touched[rsrc]
        new_dist = seg_min(d, rdst, torch.where(active_e, d[rsrc] + rw, torch.inf))
        return SuperstepResult(
            new_dist, new_dist < d, we, wv, seg_count(active_e, rpart),
            torch.tensor(iters, dtype=torch.int32, device=device),
        )

    return superstep


class TraversalResult(NamedTuple):
    """One batched traversal: tensors from the device program, numpy
    leaves once ``run`` has pulled them to the host."""

    dist: torch.Tensor  # [S, n] final state (float32, or int32 for WCC)
    frontier: torch.Tensor  # [S, n] bool; non-empty only if m_max was hit
    n_supersteps: torch.Tensor  # [S] int32 supersteps each source ran
    edges_examined: torch.Tensor  # [S, m_max, P] int32
    verts_processed: torch.Tensor  # [S, m_max, P] int32
    msgs_sent: torch.Tensor  # [S, m_max, P] int32
    inner_iters: torch.Tensor  # [S, m_max] int32
    sg_active: torch.Tensor  # [S, m_max, n_sg] bool, or [S, m_max, 0] if off
    wire_msgs: torch.Tensor  # [S, m_max] int32 (0 on the dense path)

    def asdict(self) -> dict:
        """Schema-versioned named-field view (``graph.config``), the same
        dict shape as the JAX package's ``TraversalResult.asdict()``."""
        return versioned_report("traversal_result", dict(self._asdict()))


class TraversalNotConverged(RuntimeError):
    """Raised by ``TraversalEngine.run`` when some source still has a
    non-empty frontier after ``m_max`` supersteps.  The partial
    ``TraversalResult`` is kept on ``.result`` (host-side numpy leaves)."""

    def __init__(self, m_max: int, result: "TraversalResult"):
        self.result = result
        steps = np.asarray(result.n_supersteps).tolist()
        stuck = np.flatnonzero(result.frontier.any(axis=1)).tolist()
        super().__init__(
            f"BSP did not converge within {m_max} supersteps "
            f"(per-source n_supersteps={steps}, unconverged sources={stuck})"
        )


class WindowState(NamedTuple):
    """Device-resident carried state between windows."""

    dist: torch.Tensor  # [S, n]
    frontier: torch.Tensor  # [S, n] bool
    n_supersteps: torch.Tensor  # [S] int32, cumulative over all windows


class WindowResult(NamedTuple):
    """One window of supersteps: carried device state + the pulled counters
    (host numpy); rows past a source's convergence are zero."""

    state: WindowState  # device-resident; feed to the next run_window
    n_supersteps: np.ndarray  # [S] int32, cumulative (incl. this window)
    edges_examined: np.ndarray  # [S, k, P] int32
    verts_processed: np.ndarray  # [S, k, P] int32
    msgs_sent: np.ndarray  # [S, k, P] int32
    inner_iters: np.ndarray  # [S, k] int32
    part_active_next: np.ndarray  # [S, P] bool, parts active at the next superstep
    done: np.ndarray  # [S] bool, frontier empty (traversal converged)


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class TraversalEngine:
    """Device-resident multi-source BSP traversal over a static CSR layout.

    ``config.device`` places state, layouts and counters (a CUDA device
    without CUDA raises); ``config.backend`` picks the relax reduction.
    ``host_syncs`` counts the booleans read back to the host by every
    launch (loop conditions) plus one per bulk pull of results.
    """

    def __init__(
        self,
        pg: PartitionedGraph,
        *,
        program: VertexProgram | None = None,
        config: EngineConfig | None = None,
    ):
        cfg = config or EngineConfig()
        self.config = cfg
        self.device = resolve_device(cfg.device)
        self.backend = validate_backend(cfg.backend, self.device)
        self.pg = pg
        self.program = validate_program(program or SsspProgram())
        self.m_max = int(cfg.m_max)
        self.collect_subgraphs = bool(cfg.collect_subgraphs)
        self.n = pg.graph.n_vertices
        self.n_parts = pg.n_parts
        self.n_subgraphs = pg.n_subgraphs if self.collect_subgraphs else 0
        self.host_syncs = 0
        layout = partitioned_edge_layout(pg)
        reduce = self.program.reduce
        self._relax_l = make_relax_fn(
            layout.local, reduce=reduce, device=self.device, backend=self.backend
        )
        self._relax_r = make_relax_fn(
            layout.remote, reduce=reduce, device=self.device, backend=self.backend
        )
        self._dev = _device_arrays(pg, self.device)
        self._lw, self._rw = plane_arrays(pg, self.program, self.device)
        self._sg = None
        if self.collect_subgraphs:
            self._sg = _pg_cached(
                pg, "_sg_device", (str(self.device),),
                lambda: torch.as_tensor(
                    pg.subgraph_of_vertex.astype(np.int64), device=self.device
                ),
            )

    # -- state layout (identity on the dense engine) ------------------------

    @property
    def device_of_part(self) -> None:
        """The active partition -> device map: ``None`` on the dense engine,
        where one device computes every partition (a map comes with the
        multi-GPU engine)."""
        return None

    @property
    def state_index_of_vertex(self) -> np.ndarray:
        """[n] index of each vertex in the carried state's trailing axis:
        the identity on the dense engine."""
        return np.arange(self.n, dtype=np.int64)

    def gather_global(self, state_rows) -> np.ndarray:
        """Carried state rows ``[..., n]`` (a tensor on any device, or host
        numpy) in global vertex order on the host: the identity on the
        dense engine."""
        if isinstance(state_rows, torch.Tensor):
            return _to_host(state_rows)
        return np.asarray(state_rows)

    def _any(self, t: torch.Tensor) -> bool:
        """One host read of ``t.any()`` -- a loop condition."""
        self.host_syncs += 1
        return bool(t.any())

    # -- device program ------------------------------------------------------

    def _window_impl(
        self,
        dist: torch.Tensor,
        frontier: torch.Tensor,
        nst0: torch.Tensor,
        m_max: int,
    ):
        s_batch = dist.shape[0]
        n, p = self.n, self.n_parts
        prog = self.program
        ident = prog.identity.item()
        dev = self._dev
        i32 = torch.int32
        kw = dict(device=self.device)

        def identity_base():
            return torch.full((s_batch, n), ident, dtype=dist.dtype, **kw)

        def candidates(d, active, src, w):
            # the gather stays outside the kernel, as in the JAX package
            relaxed = prog.relax(d.index_select(1, src), w)
            return torch.where(active, relaxed, ident).to(dist.dtype).contiguous()

        def seg_any_sg(f):
            hits = torch.zeros((s_batch, self.n_subgraphs), dtype=i32, **kw)
            return hits.index_add_(1, self._sg, f.to(i32)) > 0

        def stationary_body(d, fr, nst):
            # one gather pass over local + remote edges, program.apply at the
            # boundary, frontier drained by the iteration budget
            active_le = fr.index_select(1, dev.lsrc)
            acc = self._relax_l(
                candidates(d, active_le, dev.lsrc, self._lw), identity_base()
            )
            sums = _part_sums(torch.cat([fr * dev.ldeg, fr * dev.rdeg, fr]), dev)
            we_s, ms_s, wv_s = sums[:s_batch], sums[s_batch:-s_batch], sums[-s_batch:]
            it_s = fr.any(dim=1).to(i32)  # one pass per superstep
            active_re = fr.index_select(1, dev.rsrc)
            acc = self._relax_r(candidates(d, active_re, dev.rsrc, self._rw), acc)
            new_d = prog.apply(d, acc, n)
            next_fr = fr & prog.keep_running(nst)[:, None]
            return new_d, next_fr, we_s, wv_s, ms_s, it_s

        def monotone_body(d, fr, nst):
            del nst
            # -- local closure over the partition-local edges ---------------
            d_i, f_i, touched = d, fr, fr
            we_s = torch.zeros((s_batch, p), dtype=i32, **kw)
            wv_s = torch.zeros((s_batch, p), dtype=i32, **kw)
            it_s = torch.zeros((s_batch,), dtype=i32, **kw)
            while self._any(f_i):
                active_e = f_i.index_select(1, dev.lsrc)
                new_d = self._relax_l(candidates(d_i, active_e, dev.lsrc, self._lw), d_i)
                improved = prog.is_active(new_d, d_i)
                sums = _part_sums(torch.cat([f_i * dev.ldeg, f_i]), dev)
                we_s = we_s + sums[:s_batch]
                wv_s = wv_s + sums[s_batch:]
                it_s = it_s + f_i.any(dim=1).to(i32)
                d_i, f_i, touched = new_d, improved, touched | improved
            # -- remote exchange at the superstep boundary ------------------
            active_re = touched.index_select(1, dev.rsrc)
            new_d = self._relax_r(candidates(d_i, active_re, dev.rsrc, self._rw), d_i)
            next_fr = prog.is_active(new_d, d_i)
            ms_s = _part_sums(touched * dev.rdeg, dev)
            return new_d, next_fr, we_s, wv_s, ms_s, it_s

        superstep_body = stationary_body if prog.stationary else monotone_body

        we = torch.zeros((s_batch, m_max, p), dtype=i32, **kw)
        wv = torch.zeros_like(we)
        ms = torch.zeros_like(we)
        it = torch.zeros((s_batch, m_max), dtype=i32, **kw)
        sg = torch.zeros((s_batch, m_max, self.n_subgraphs), dtype=torch.bool, **kw)
        d, fr, nst = dist, frontier, nst0
        s = 0
        while s < m_max and self._any(fr):
            if self.collect_subgraphs:
                sg[:, s] = seg_any_sg(fr)
            nst = nst + fr.any(dim=1).to(i32)
            d, fr, we[:, s], wv[:, s], ms[:, s], it[:, s] = superstep_body(d, fr, nst)
            s += 1
        # next-superstep partition activity + done flags, computed on the
        # device so a placement decision needs no [n]-sized pull
        pact = _part_sums(fr, dev) > 0
        done = ~fr.any(dim=1)
        wire = torch.zeros((s_batch, m_max), dtype=i32, **kw)  # dense: no wire
        return TraversalResult(d, fr, nst, we, wv, ms, it, sg, wire), pact, done

    # -- host API ------------------------------------------------------------

    def init_state(self, sources) -> WindowState:
        """Device-resident initial state for ``run_window``.

        The program defines the initial ``(state, frontier)`` in global
        vertex order (``sources`` sizes the batch for source-free programs
        like WCC/PageRank).
        """
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
        state, frontier = self.program.init(self.pg, sources)
        return WindowState(
            torch.as_tensor(state, device=self.device),
            torch.as_tensor(frontier, device=self.device),
            torch.zeros((sources.shape[0],), dtype=torch.int32, device=self.device),
        )

    def backfill_rows(self, state: WindowState, rows, sources) -> WindowState:
        """Replace carried-state batch rows at a window boundary.

        ``sources[i] >= 0`` re-initializes row ``rows[i]`` from that source
        through ``program.init`` -- the row a fresh ``init_state`` batch
        would carry.  ``sources[i] == -1`` *deactivates* the row: identity
        state, empty frontier.  Either way the row's ``n_supersteps``
        restarts at 0.  The input state is not modified.
        """
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
        if rows.shape != sources.shape:
            raise ValueError(
                f"rows {rows.shape} and sources {sources.shape} must match"
            )
        if rows.size == 0:
            return state
        s_batch = int(state.dist.shape[0])
        if np.unique(rows).size != rows.size or (rows < 0).any() or (
            rows >= s_batch
        ).any():
            raise ValueError(f"rows must be unique in [0, {s_batch}): {rows}")
        live = sources >= 0
        fresh = self.init_state(np.where(live, sources, 0))
        rows_t = torch.as_tensor(rows, device=self.device)
        live_t = torch.as_tensor(live, device=self.device)[:, None]
        dist = state.dist.clone()
        frontier = state.frontier.clone()
        nst = state.n_supersteps.clone()
        dist[rows_t] = torch.where(live_t, fresh.dist, self.program.identity.item())
        frontier[rows_t] = fresh.frontier & live_t
        nst[rows_t] = 0
        return WindowState(dist, frontier, nst)

    def run_window(self, state: WindowState, k: int) -> WindowResult:
        """Run up to ``k`` more supersteps from ``state``.

        Sources whose frontier empties mid-window simply stop contributing
        counter rows (no convergence raise -- check ``done``).  The counters
        come back to the host; the carried state stays on the device.
        """
        k = int(k)
        if k < 1:
            raise ValueError(f"window size must be >= 1, got {k}")
        res, pact, done = self._window_impl(
            state.dist, state.frontier, state.n_supersteps, k
        )
        self.host_syncs += 1
        return WindowResult(
            state=WindowState(res.dist, res.frontier, res.n_supersteps),
            n_supersteps=_to_host(res.n_supersteps),
            edges_examined=_to_host(res.edges_examined),
            verts_processed=_to_host(res.verts_processed),
            msgs_sent=_to_host(res.msgs_sent),
            inner_iters=_to_host(res.inner_iters),
            part_active_next=_to_host(pact),
            done=_to_host(done),
        )

    def run(self, sources) -> TraversalResult:
        """Run one batched traversal from ``sources`` (host ints).

        Returns the host-side ``TraversalResult`` (numpy leaves).  Raises
        ``TraversalNotConverged`` (with the partial result attached) if any
        source failed to converge within ``m_max`` supersteps.
        """
        state = self.init_state(sources)
        res, _, _ = self._window_impl(
            state.dist, state.frontier, state.n_supersteps, self.m_max
        )
        self.host_syncs += 1
        res = TraversalResult(*(_to_host(t) for t in res))
        if not self.program.converged(bool(res.frontier.any())):
            raise TraversalNotConverged(self.m_max, res)
        return res


def get_engine(
    pg: PartitionedGraph,
    *,
    program: VertexProgram | None = None,
    config: EngineConfig | None = None,
) -> TraversalEngine:
    """Per-graph engine cache (keyed by the knobs, stored on the instance).

    Engines are keyed by ``program.key`` (default ``SsspProgram``), the
    resolved device and backend, ``m_max`` and ``collect_subgraphs``.
    """
    cfg = config or EngineConfig()
    device = resolve_device(cfg.device)
    backend = validate_backend(cfg.backend, device)
    prog_key = (program or SsspProgram()).key
    key = (
        int(cfg.m_max), bool(cfg.collect_subgraphs), prog_key,
        str(backend), str(device),
    )
    return _pg_cached(
        pg, "_traversal_engines", key,
        lambda: TraversalEngine(pg, program=program, config=cfg),
    )


# -- numpy reference implementations (test oracles) ---------------------------


def _bellman_ford(
    n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray, source: int
) -> np.ndarray:
    dist = np.full(n, np.inf, dtype=np.float64)
    dist[source] = 0.0
    for _ in range(n):
        cand = dist[src] + w
        new = dist.copy()
        np.minimum.at(new, dst, cand)
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def reference_bfs(pg: PartitionedGraph, source: int) -> np.ndarray:
    """Hop-count oracle: BFS levels regardless of any edge weights."""
    g = pg.graph
    return _bellman_ford(
        g.n_vertices, g.src, g.dst, np.ones(g.n_edges, dtype=np.float64), source
    )


def reference_sssp(pg: PartitionedGraph, source: int) -> np.ndarray:
    """*Weighted* shortest-path oracle (Bellman-Ford over ``edge_weights``)."""
    g = pg.graph
    return _bellman_ford(
        g.n_vertices, g.src, g.dst, g.edge_weights.astype(np.float64), source
    )


def reference_wcc(pg: PartitionedGraph) -> np.ndarray:
    """Min-label-propagation oracle: on the symmetrized generator graphs,
    the smallest vertex id in each weakly-connected component."""
    g = pg.graph
    labels = np.arange(g.n_vertices, dtype=np.int64)
    while True:
        new = labels.copy()
        np.minimum.at(new, g.dst, labels[g.src])
        if np.array_equal(new, labels):
            return labels
        labels = new


def reference_pagerank(
    pg: PartitionedGraph, damping: float = 0.85, num_iters: int = 20
) -> np.ndarray:
    """Power-iteration oracle matching ``PageRankProgram``: fixed budget,
    no dangling-mass redistribution, float64."""
    g = pg.graph
    n = g.n_vertices
    contrib_w = 1.0 / np.maximum(g.out_degree, 1).astype(np.float64)
    rank = np.full(n, 1.0 / n, dtype=np.float64)
    for _ in range(num_iters):
        acc = np.zeros(n, dtype=np.float64)
        np.add.at(acc, g.dst, rank[g.src] * contrib_w[g.src])
        rank = (1.0 - damping) / n + damping * acc
    return rank
