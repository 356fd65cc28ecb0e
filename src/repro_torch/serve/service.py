"""Traversal-as-a-service: deterministic simulated-clock serving loop (the
port of ``repro.serve.service``).  ``engine_config=`` selects the engine;
with ``EngineConfig.mesh`` every rank runs the same service loop on its
block of the mesh engine's state (the decisions read only global counters,
so they agree on every rank).

``TraversalService.run(trace)`` consumes an open-loop arrival trace --
``(arrival_time, TraversalQuery)`` pairs in simulated seconds -- and drives
the subsystem end to end: admission (``serve.queue``), micro-batching into
the engine's fixed ``[S]`` batch axis (``serve.batcher``), window-granular
capacity control (``serve.scheduler``), and billing through the existing
``CostReport`` two-ledger split (``core.billing.evaluate`` over the executed
placement, with VM-change migration seconds billed exactly like the elastic
executor's).

The event loop is **simulated-clock only**: time advances by the executed
supersteps' modeled durations (calibrated work counters x ``alpha``/``beta``
rates, LPT-packed onto the scheduled VM slots) and by jumps to the next
arrival when the service is idle.  No wall-clock reading exists anywhere in
the decision path, so two ``run(trace)`` calls on the same trace return
bit-for-bit identical ``ServiceReport``s -- on either backend, and equal to
the JAX package's (``tests/test_torch_serve.py``, ``chip_smoke.py``).

Per service turn (round-robin over lanes with work):

  1. admit every arrival with ``t <= clock`` (backpressure beyond
     ``queue_capacity`` rejects -- a loss system),
  2. backfill freed batch rows from the lane's queue head (one row scatter
     on the state's device; the batch shape never changes),
  3. ask the scheduler for this window's VM capacity (activity forecast +
     Ghaderi queue drift),
  4. launch one engine window, advance the clock by the executed supersteps'
     durations (max VM busy incl. migration seconds),
  5. retire converged rows (sojourn = completion clock - arrival; window
     granular), requeue rows that hit ``superstep_cap`` unconverged --
     the service twin of ``TraversalNotConverged``, with partial state
     dropped and the attempt counted in ``ServiceReport.requeued`` -- and
     drop queries past ``max_requeues``.

Writing a *schedulable* workload (mirroring the "analyzable VertexProgram"
note in ``graph.program``): any ``VertexProgram`` can be served, but the
capacity scheduler is only as good as the activity signal the program
produces, so keep the spec honest about its shape.  Monotone traversals
(``stationary=False``) expose a decaying active-partition sweep the
forecast can exploit; stationary programs must declare a finite
``superstep_budget`` -- it bounds per-query work, and ``superstep_cap``
should sit above it or every query requeues; and ``initial_active_parts``
must be cheap and host-side, because the scheduler calls it per backfilled
row to seed the forecast before any counter exists.  Queries only share a
batch when their programs agree under ``VertexProgram.key``, so
parameterized programs (e.g. PageRank damping) get separate lanes -- and
separate engines -- per parameterization.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.billing import BillingModel, CostReport, evaluate
from repro_torch.core.placement import Placement
from repro_torch.core.replan import ReplanConfig
from repro_torch.core.timing import DEFAULT_ALPHA, DEFAULT_BETA
from repro_torch.graph import deltas as graph_deltas
from repro_torch.graph.config import EngineConfig, resolve_device, versioned_report
from repro_torch.graph.program import SsspProgram
from repro_torch.graph.traversal import get_engine
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.queue import Admitted, AdmissionQueue, TraversalQuery, lane_key
from repro_torch.serve.scheduler import CapacityScheduler, lpt_rows


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of one service instance (see module docstring for the loop)."""

    s_batch: int = 8  # physical batch rows per lane (fixed batch shape)
    window: int = 8  # supersteps per engine launch
    superstep_cap: int = 64  # per-query cap before requeue
    max_requeues: int = 2  # requeues before a query is dropped
    queue_capacity: int = 256  # admission bound (backpressure past it)
    min_vms: int = 1
    max_vms: int = 8
    latency_stretch: float = 2.0  # scheduler latency guard (see serve.scheduler)
    queue_weight: float = 0.125  # Ghaderi drift: VMs per queued query
    static_vms: int | None = None  # pin capacity (static baseline) when set
    alpha: float = DEFAULT_ALPHA  # secs per processed vertex
    beta: float = DEFAULT_BETA  # secs per examined edge
    tau_scale: float = 1.0
    billing: BillingModel = dataclasses.field(default_factory=BillingModel)


@dataclasses.dataclass(frozen=True)
class QueryRecord:
    """Per-completed-query ledger entry (simulated seconds)."""

    qid: int
    lane: str
    source: int
    arrival: float
    dispatched: float  # entered a batch row
    finished: float  # window boundary where the row retired
    supersteps: int  # supersteps of the final (successful) attempt
    requeues: int
    deadline_missed: bool

    @property
    def sojourn(self) -> float:
        return self.finished - self.arrival


@dataclasses.dataclass(frozen=True)
class ServiceReport:
    """One ``run(trace)``'s outcome; every field derives from the simulated
    clock and the executed counters (bit-for-bit replayable)."""

    offered: int
    completed: int
    rejected: int  # backpressured at admission
    requeued: int  # unconverged-at-cap re-admissions
    dropped: int  # queries past max_requeues (partial state discarded)
    deadline_misses: int
    windows: int  # engine launches
    supersteps: int  # executed supersteps across all windows
    sim_seconds: float  # total simulated makespan incl. idle gaps
    busy_seconds: float  # sum of executed superstep durations
    queries_per_sec: float
    sojourn_p50: float
    sojourn_p95: float
    sojourn_p99: float
    occupancy: float  # mean fraction of batch rows holding real queries
    capacity_mean: float  # mean scheduled VMs per executed superstep
    capacity_peak: int
    queue_peak_depth: int
    cost: CostReport  # billed through the existing two-ledger split
    cost_per_1k_queries: float
    queries: tuple[QueryRecord, ...]  # completed queries, admission order
    mutations_applied: int = 0  # delta buffers merged during the run

    def asdict(self) -> dict:
        """Schema-versioned dict form (see ``graph.config``; contract in
        ``graph/__init__``).  Nested reports recurse: ``cost`` and each
        ``QueryRecord`` become plain dicts."""
        fields = dataclasses.asdict(self)
        return versioned_report("service_report", fields)


def poisson_trace(
    n_queries: int,
    rate: float,
    n_vertices: int,
    *,
    seed: int = 0,
    program=None,
    deadline: float | None = None,
) -> tuple[tuple[float, TraversalQuery], ...]:
    """Seeded open-loop Poisson arrivals: exponential gaps at ``rate``
    queries/sec, sources uniform over the graph.  Deterministic per seed --
    the replayable input the service's determinism contract is stated over.
    """
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate, size=n_queries))
    sources = rng.integers(0, n_vertices, size=n_queries)
    return tuple(
        (float(t), TraversalQuery(int(s), program, deadline))
        for t, s in zip(times, sources)
    )


class _Lane:
    """One program lane: its engine, batcher, and dispatch bookkeeping."""

    def __init__(self, key: str, engine, s_batch: int):
        self.key = key
        self.engine = engine
        self.batcher = MicroBatcher(engine, s_batch)
        self.dispatched: dict[int, float] = {}  # qid -> first dispatch clock


class TraversalService:
    """Traversal-serving front end over ``TraversalEngine`` (module docstring).

    One instance serves one partitioned graph; ``run(trace)`` is stateless
    across calls (fresh queue/batcher/scheduler per run) so replays are
    exact.  Engines are shared through the per-graph ``get_engine`` cache.
    """

    #: hard ceiling on service turns per run -- a diverging workload (e.g. a
    #: program that never converges and always requeues) fails loudly
    #: instead of looping forever
    MAX_TURNS = 1_000_000

    def __init__(
        self,
        pg,
        *,
        config: ServiceConfig | None = None,
        default_program=None,
        engine_config: EngineConfig | None = None,
    ):
        self.pg = pg
        self.config = config or ServiceConfig()
        self.default_program = default_program or SsspProgram()
        self.engine_config = engine_config or EngineConfig()
        resolve_device(self.engine_config.device)  # a CUDA config without CUDA raises
        self._default_key = str(self.default_program.key)
        itemsize = np.dtype(self.default_program.dtype).itemsize
        nv, _ = pg.partition_sizes
        self.partition_bytes = (itemsize * nv).astype(np.int64)

    def _engine_for(self, program, pg=None):
        return get_engine(
            pg if pg is not None else self.pg,
            program=program,
            config=self.engine_config,
        )

    def _program_of_lane(self, rec: Admitted):
        return (
            rec.query.program
            if rec.query.program is not None
            else self.default_program
        )

    def _apply_mutation(self, buf, lanes: dict) -> None:
        """Merge one due delta buffer into the serving graph, in place.

        The graph swap happens *between* service turns (a window boundary for
        every lane), so in-flight batch state is carried exactly: edge-only
        inserts leave the vertex plane untouched (the dense carry is the
        identity, a mesh one a pure ``relayout_state`` permutation when an
        edge pad grew), and every inserted-edge source re-enters the
        frontier so monotone lanes converge to the mutated graph's fixpoint
        (``graph.deltas``).  Each lane's engine is rebuilt on the new graph;
        mesh lanes merge their layout incrementally first
        (``merged_mesh_layout``), so the rebuild reuses unchanged blocks.
        Deletes cannot be un-relaxed, so a buffer with deletes is only
        accepted while no lane holds live rows (idle lanes drop their
        phantom-only state instead).
        """
        live = [ln for ln in lanes.values() if ln.batcher.n_live > 0]
        if buf.has_deletes and live:
            raise ValueError(
                "cannot merge deletes while queries are in flight: a delete "
                "cannot be un-relaxed (drain the lanes first)"
            )
        for lane in live:
            if getattr(lane.engine.program, "stationary", False):
                raise ValueError(
                    "state carry across a merge is monotone-programs-only "
                    f"(lane {lane.key} is stationary with live rows)"
                )
        old_pg = self.pg
        new_pg, _ = graph_deltas.merge_buffer(old_pg, buf)
        if new_pg is old_pg:
            return
        isrc, _, _ = buf.inserts()
        for lane in lanes.values():
            old_prog = lane.engine._mesh_prog
            old_layout = None if old_prog is None else old_prog.layout
            if old_layout is not None:
                graph_deltas.merged_mesh_layout(
                    old_pg, new_pg, old_layout, mesh=self.engine_config.mesh
                )
            new_engine = self._engine_for(lane.engine.program, new_pg)
            batcher = lane.batcher
            if batcher.state is not None and batcher.n_live == 0:
                # phantom-only state: cheaper to cold-start than to carry
                batcher.state = None
                batcher.last_nst[:] = 0
                batcher._kills.clear()
            elif batcher.state is not None:
                new_prog = new_engine._mesh_prog
                new_layout = None if new_prog is None else new_prog.layout
                identity = new_engine.program.identity
                state = graph_deltas.carry_state(
                    old_layout, new_layout, batcher.state,
                    identity=identity, mesh=self.engine_config.mesh,
                )
                if isrc.size:
                    state = graph_deltas.reactivate_sources(
                        state, new_layout, isrc, identity=identity,
                        rank=None if new_prog is None else new_prog.rank,
                    )
                batcher.state = state
            lane.engine = new_engine
            batcher.engine = new_engine
        self.pg = new_pg
        itemsize = np.dtype(self.default_program.dtype).itemsize
        nv, _ = new_pg.partition_sizes
        self.partition_bytes = (itemsize * nv).astype(np.int64)

    def run(self, trace, mutations=None) -> ServiceReport:
        """Serve ``trace`` to completion and return the ``ServiceReport``.

        ``mutations`` is an optional feed of ``(sim_time, EdgeDeltaBuffer)``
        pairs: each buffer merges into the serving graph at the first turn
        boundary whose simulated clock has passed its time, interleaved with
        query traffic (``_apply_mutation``).  The run drains both the arrival
        trace and the mutation feed before returning.
        """
        cfg = self.config
        arrivals = sorted(trace, key=lambda tq: tq[0])
        offered = len(arrivals)
        muts = sorted(mutations or (), key=lambda tb: float(tb[0]))
        next_mut = 0
        mutations_applied = 0
        queue = AdmissionQueue(cfg.queue_capacity, default_key=self._default_key)
        sched = CapacityScheduler(
            self.pg.n_parts,
            min_vms=cfg.min_vms,
            max_vms=cfg.max_vms,
            latency_stretch=cfg.latency_stretch,
            queue_weight=cfg.queue_weight,
            static_vms=cfg.static_vms,
            config=ReplanConfig.for_program(self.default_program),
        )
        lanes: dict[str, _Lane] = {}
        clock = 0.0
        next_arrival = 0
        taus: list[np.ndarray] = []
        vm_rows: list[np.ndarray] = []
        mig_busy_rows: list[np.ndarray] = []
        prev_vm = np.full(self.pg.n_parts, -1, dtype=np.int64)
        caps: list[int] = []
        occupancies: list[float] = []
        completed: list[QueryRecord] = []
        dropped = 0
        windows = 0
        rr = 0  # round-robin cursor over lane keys

        def lane_of(rec: Admitted) -> _Lane:
            key = lane_key(rec.query, self._default_key)
            lane = lanes.get(key)
            if lane is None:
                lane = _Lane(
                    key, self._engine_for(self._program_of_lane(rec)),
                    cfg.s_batch,
                )
                lanes[key] = lane
            return lane

        for _turn in range(self.MAX_TURNS):
            # -- 0. merge delta buffers the clock has passed -----------------
            while next_mut < len(muts) and muts[next_mut][0] <= clock + 1e-12:
                self._apply_mutation(muts[next_mut][1], lanes)
                next_mut += 1
                mutations_applied += 1

            # -- 1. admit everything that has arrived by now -----------------
            while (
                next_arrival < offered
                and arrivals[next_arrival][0] <= clock + 1e-12
            ):
                t_arr, query = arrivals[next_arrival]
                rec = queue.offer(query, t_arr)
                if rec is not None:
                    lane_of(rec)  # materialize the lane (engine warmup)
                next_arrival += 1

            # -- pick a lane with work (queued or in flight), round-robin ----
            keys = list(lanes)
            runnable = [
                k
                for k in keys
                if queue.depth(k) > 0 or lanes[k].batcher.n_live > 0
            ]
            if not runnable:
                if next_arrival >= offered and next_mut >= len(muts):
                    break  # drained: no arrivals, no mutations, rows idle
                jumps = []
                if next_arrival < offered:
                    jumps.append(float(arrivals[next_arrival][0]))
                if next_mut < len(muts):
                    jumps.append(float(muts[next_mut][0]))
                clock = max(clock, min(jumps))
                continue
            key = runnable[rr % len(runnable)]
            rr += 1
            lane = lanes[key]
            batcher = lane.batcher

            # -- 2. window-boundary backfill from this lane's queue ----------
            free = cfg.s_batch if batcher.state is None else batcher.free
            recs = queue.take(key, free)
            for rec in recs:
                lane.dispatched.setdefault(rec.qid, clock)
            batcher.admit(recs)
            if batcher.n_live == 0:
                continue  # only deactivations pending; nothing to run

            # -- 3. capacity decision for this window ------------------------
            decision = sched.decide(len(queue), batcher.active_next())
            occupancies.append(batcher.n_live / cfg.s_batch)

            # -- 4. one engine launch, clock += executed durations -----------
            live = batcher.live_mask
            wres = lane.engine.run_window(batcher.state, cfg.window)
            steps = batcher.commit_window(wres)
            windows += 1
            for t in range(steps):
                # bill real rows only: phantom padding rows duplicate a real
                # row's work for shape stability and ride the launch for free
                verts = wres.verts_processed[live, t].sum(axis=0).astype(np.float64)
                edges = wres.edges_examined[live, t].sum(axis=0).astype(np.float64)
                active = verts > 0
                tau_row = cfg.tau_scale * (cfg.alpha * verts + cfg.beta * edges)
                tau_row = np.where(active, tau_row, 0.0)
                vm_row = lpt_rows(tau_row, decision.n_vms)
                # VM-change migrations, billed like the elastic executor's:
                # the receiving VM's busy time grows by bytes/bandwidth
                mig = np.zeros(cfg.max_vms, dtype=np.float64)
                for i in np.flatnonzero(vm_row >= 0):
                    j = int(vm_row[i])
                    if 0 <= prev_vm[i] != j:
                        mig[j] += (
                            self.partition_bytes[i] / cfg.billing.move_bandwidth
                        )
                    prev_vm[i] = j
                loads = np.zeros(cfg.max_vms, dtype=np.float64)
                placed = vm_row >= 0
                np.add.at(loads, vm_row[placed], tau_row[placed])
                clock += float((loads + mig).max()) if placed.any() else 0.0
                taus.append(tau_row)
                vm_rows.append(vm_row)
                mig_busy_rows.append(mig)
                caps.append(decision.n_vms)
                sched.observe(tau_row)

            # -- 5. retire / requeue at the window boundary ------------------
            for row in np.flatnonzero(live):
                row = int(row)
                rec = batcher.slots[row]
                if bool(wres.done[row]):
                    batcher.retire(row)
                    ddl = rec.query.deadline
                    completed.append(
                        QueryRecord(
                            qid=rec.qid,
                            lane=key,
                            source=int(rec.query.source),
                            arrival=float(rec.arrival),
                            dispatched=float(lane.dispatched.pop(rec.qid)),
                            finished=float(clock),
                            supersteps=int(wres.n_supersteps[row]),
                            requeues=rec.requeues,
                            deadline_missed=(
                                ddl is not None and clock - rec.arrival > ddl
                            ),
                        )
                    )
                elif int(wres.n_supersteps[row]) >= cfg.superstep_cap:
                    # the service twin of TraversalNotConverged: drop the
                    # partial state (the row is deactivated by the next
                    # admit surgery) and re-admit at the lane tail
                    batcher.mark_kill(row)
                    if rec.requeues >= cfg.max_requeues:
                        dropped += 1
                        lane.dispatched.pop(rec.qid, None)
                    else:
                        queue.requeue(rec)
        else:
            raise RuntimeError(
                f"service did not drain within {self.MAX_TURNS} turns"
            )

        # -- bill the executed placement through the standard evaluator ------
        n_parts = self.pg.n_parts
        tau = np.vstack(taus) if taus else np.zeros((0, n_parts))
        executed = Placement(
            strategy=(
                "serve-elastic"
                if cfg.static_vms is None
                else f"serve-static[{cfg.static_vms}]"
            ),
            tau=tau,
            vm_of=(
                np.vstack(vm_rows)
                if vm_rows
                else np.zeros((0, n_parts), np.int64)
            ),
        )
        mig_busy = np.vstack(mig_busy_rows) if mig_busy_rows else None
        if mig_busy is not None and not mig_busy.any():
            mig_busy = None
        cost = evaluate(executed, cfg.billing, migration_busy=mig_busy)

        completed.sort(key=lambda r: r.qid)
        sojourns = np.array([r.sojourn for r in completed], dtype=np.float64)
        p50, p95, p99 = (
            (
                float(np.percentile(sojourns, 50)),
                float(np.percentile(sojourns, 95)),
                float(np.percentile(sojourns, 99)),
            )
            if sojourns.size
            # inf, not nan: nan breaks report equality (the replay
            # determinism contract) on runs where nothing completes
            else (float("inf"),) * 3
        )
        sim_seconds = float(clock)
        n_done = len(completed)
        return ServiceReport(
            offered=offered,
            completed=n_done,
            rejected=queue.rejected,
            requeued=queue.requeued,
            dropped=dropped,
            deadline_misses=sum(r.deadline_missed for r in completed),
            windows=windows,
            supersteps=len(taus),
            sim_seconds=sim_seconds,
            busy_seconds=float(cost.makespan),
            queries_per_sec=(n_done / sim_seconds if sim_seconds > 0 else 0.0),
            sojourn_p50=p50,
            sojourn_p95=p95,
            sojourn_p99=p99,
            occupancy=(
                float(np.mean(occupancies)) if occupancies else 0.0
            ),
            capacity_mean=(float(np.mean(caps)) if caps else 0.0),
            capacity_peak=(max(caps) if caps else 0),
            queue_peak_depth=queue.peak_depth,
            cost=cost,
            cost_per_1k_queries=(
                cost.cost / n_done * 1000.0 if n_done else float("inf")
            ),
            queries=tuple(completed),
            mutations_applied=mutations_applied,
        )
