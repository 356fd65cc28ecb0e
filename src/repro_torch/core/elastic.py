"""Elastic BSP executor: run a subgraph-centric job under a placement
schedule on the dense engine, with the card's devices standing in for cloud
VMs (the port of ``repro.core.elastic``, without the mesh engine).

The executed job is any ``graph.program.VertexProgram`` (``program=``):
non-stationary traversals (BFS/SSSP/WCC) whose active partition set sweeps
and dies out, or stationary algorithms (PageRank) that keep every partition
hot for a fixed budget -- the contrast the paper's placement strategies are
about.  The replanner's extrapolation defaults follow the program
(``ReplanConfig.for_program``).

The mapping from the paper's cloud model to the port:

  VM slot j            -> a torch device of the configured type (every
                          visible ``cuda:i`` for a CUDA config, the CPU for
                          a CPU one), round-robin (``placement.device_of_vm``)
  partition placement  -> the partition's VM (and so its device); when the
                          schedule moves it, the transfer
                          (``partition_bytes / move_bandwidth``) is billed
                          into the receiving VM's busy time (pinned
                          strategies therefore never move state and pay no
                          migration seconds).  The state itself stays in
                          the dense engine's one plane; copying shards
                          between devices comes with the mesh engine, the
                          first reader of such copies
  superstep compute    -> the dense engine's window on ``config.device``
                          (mathematically equal to per-VM sequential
                          execution of its partitions; per-VM time is
                          accounted from the exact work counters x the
                          calibrated rate)
  billing              -> ``core.billing`` on the *actual* executed trace

Windowed execution: ``EngineConfig.window = k`` executes ``k`` supersteps
per engine window and pulls only the ``O(k*P)`` counter window at each
placement point -- one bulk pull per window (``ceil(S/k) + 1`` per run, the
+1 being the final state pull), counted in ``ExecutionReport.host_syncs``
as the JAX package counts them.  The engine's loop conditions read one
boolean per superstep and per closure iteration besides
(``TraversalEngine.host_syncs`` counts those).  ``window=1`` is the
per-superstep path, bit-identical in ``dist`` and work counters for any
``k``.  The window loop reads nothing back besides the window's counters.

Two ledgers are kept apart: ``migration_bytes`` / ``CostReport.
migration_secs`` bill the plan's simulated cloud moves (every VM change,
priced at ``move_bandwidth``), the same for any device count;
``device_moves`` / ``device_move_bytes`` count the moves whose VMs map onto
different devices (none with one card).  ``relayouts`` and ``relayouts_skipped`` stay
in the report and are always 0 here: re-laying the compute out per window
needs the mesh engine, which is not ported yet.

``replan=True`` re-plans online when the actually-active partition set
diverges from the plan at a window boundary (``core.replan``); ``sketch``
(a metagraph ``TimeFunction``) refines the extrapolation.  ``mutations=``
merges edge-delta buffers at window boundaries (insert-only,
monotone-only) and ``repartition=`` runs one bounded repartition pass after
each merge (``core.repartition``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.billing import BillingModel, CostReport, evaluate
from repro_torch.core.placement import Placement, device_of_vm
from repro_torch.core.repartition import RepartitionConfig
from repro_torch.core.replan import OnlineReplanner, ReplanConfig
from repro_torch.core.timing import DEFAULT_ALPHA, DEFAULT_BETA, TimeFunction
from repro_torch.graph import deltas as graph_deltas
from repro_torch.graph.config import EngineConfig, versioned_report
from repro_torch.graph.program import SsspProgram, VertexProgram
from repro_torch.graph.structs import PartitionedGraph
from repro_torch.graph.traversal import get_engine


@dataclasses.dataclass
class ExecutionReport:
    dist: np.ndarray
    actual_tau: TimeFunction
    cost: CostReport
    n_supersteps: int
    n_migrations: int  # partition moves between devices
    migration_bytes: int  # total bytes of partition state moved
    replans: int
    host_syncs: int  # bulk device->host pulls (windows + final dist)
    window: int
    wall_seconds: float
    device_moves: int = 0  # shard moves that crossed real devices
    device_move_bytes: int = 0  # bytes physically transferred between devices
    residency: np.ndarray | None = None  # [n_windows, P] device per partition
    # (-1 = not yet placed), recorded at each window boundary
    relayouts: int = 0  # windows whose compute layout was swapped (mesh only)
    relayouts_skipped: int = 0  # swaps vetoed by the "auto" policy (mesh only)
    mutations_applied: int = 0  # delta buffers merged at window boundaries
    repartition_moves: int = 0  # vertices migrated by the bounded LPA pass

    @property
    def migration_secs(self) -> float:
        """bytes / move_bandwidth, billed into the makespan (single source
        of truth: the cost report)."""
        return self.cost.migration_secs

    def asdict(self) -> dict:
        """Schema-versioned named-field view (``graph.config``); consumers
        key on names -- the dataclass field order is not a contract."""
        fields = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
        }
        return versioned_report("execution_report", fields)


def _vm_devices(device: torch.device) -> list[torch.device]:
    """The devices VM slots map onto: every visible card for a CUDA engine,
    the CPU for a CPU one."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class ElasticBSPExecutor:
    """Executes any ``VertexProgram`` under a placement schedule with elastic
    devices (default program: weighted SSSP == BFS on unit weights)."""

    def __init__(
        self,
        pg: PartitionedGraph,
        *,
        program: VertexProgram | None = None,
        alpha: float = DEFAULT_ALPHA,
        beta: float = DEFAULT_BETA,
        tau_scale: float = 1.0,
        billing: BillingModel | None = None,
        config: EngineConfig | None = None,
    ):
        self.config = config or EngineConfig()
        self.program = program or SsspProgram()
        self.alpha = alpha
        self.beta = beta
        self.tau_scale = tau_scale
        self.billing = billing or BillingModel()
        self._adopt(pg)
        self.devices = _vm_devices(self.engine.device)

    def _adopt(self, pg: PartitionedGraph) -> None:
        """Take ``pg`` as the executed graph: its engine and the shard sizes
        in bytes (per the program's state dtype) for migration pricing."""
        self.pg = pg
        self.engine = get_engine(pg, program=self.program, config=self.config)
        itemsize = np.dtype(self.program.dtype).itemsize
        nv, _ = pg.partition_sizes
        self.partition_bytes = (itemsize * nv).astype(np.int64)

    def _apply_mutation(self, buf, state, repartition, replanner):
        """Window-boundary delta merge: swap graph + engine, carry state.

        Returns ``(carried_state, repartition_moves)``.  Insert-only (a
        delete cannot be un-relaxed from in-flight monotone state) and
        monotone-only; a repartition pass re-primes the replanner's sketch
        from the fresh per-partition stats.
        """
        if buf.has_deletes:
            raise ValueError(
                "elastic mutations are insert-only: a delete cannot be "
                "un-relaxed from in-flight state"
            )
        if getattr(self.program, "stationary", False):
            raise ValueError(
                "mid-run mutations are monotone-programs-only "
                f"(got stationary {self.program.key})"
            )
        new_pg, rep = graph_deltas.merge_buffer(self.pg, buf, repartition)
        self._adopt(new_pg)  # dense state is in global vertex order: no carry
        state = graph_deltas.reactivate_sources(
            state, None, buf.inserts()[0], identity=self.program.identity
        )
        if rep is not None:
            replanner.reprime(rep.part_activity)
        return state, (rep.moves if rep is not None else 0)

    def run(
        self,
        source: int,
        plan: Placement,
        *,
        strategy_fn: Callable[[TimeFunction], Placement] | None = None,
        replan: bool = False,
        replan_config: ReplanConfig | None = None,
        sketch: TimeFunction | None = None,
        max_supersteps: int = 4096,
        mutations=None,
        repartition: RepartitionConfig | bool | None = None,
    ) -> ExecutionReport:
        """Execute the program under ``plan`` (see the module docstring);
        ``EngineConfig.window`` supersteps per engine window."""
        pg = self.pg
        t0 = time.perf_counter()
        window = max(1, int(self.config.window))
        muts = sorted(mutations or (), key=lambda tb: int(tb[0]))
        mut_idx = 0
        mutations_applied = 0
        repartition_moves = 0

        state = self.engine.init_state([source])
        replanner = OnlineReplanner(
            pg.n_parts, strategy_fn,
            replan_config or ReplanConfig.for_program(self.program),
            sketch=sketch,
        )

        vm_of = plan.vm_of.copy()
        horizon = vm_of.shape[0]
        n_dev = len(self.devices)
        prev_vm = np.full(pg.n_parts, -1, dtype=np.int64)
        prev_dev = np.full(pg.n_parts, -1, dtype=np.int64)  # real device slot
        migrations = 0
        migration_bytes = 0
        device_moves = 0
        device_move_bytes = 0
        mig_events: list[tuple[int, int, float]] = []  # (superstep, vm, secs)
        replans = 0
        host_syncs = 0
        taus: list[np.ndarray] = []
        vm_rows: list[np.ndarray] = []
        residency: list[np.ndarray] = []

        s = 0
        # superstep 0's active set is program-defined and host-known (the
        # source's partition for traversals, every partition for source-free
        # programs), so the first placement decision costs no device read
        active_next = self.program.initial_active_parts(pg, [source])
        done = False

        while not done and s < max_supersteps:
            # -- window-boundary mutations: merge due delta buffers ----------
            while mut_idx < len(muts) and int(muts[mut_idx][0]) <= s:
                state, moved = self._apply_mutation(
                    muts[mut_idx][1], state, repartition, replanner
                )
                mut_idx += 1
                mutations_applied += 1
                repartition_moves += moved

            # -- placement point: (re-)plan, then commit to a whole window ---
            if s >= horizon or (
                replan and bool((active_next & (vm_of[s] < 0)).any())
            ):
                # prediction diverged (or ran past the plan): re-plan the
                # entire remaining horizon from the observed prefix
                vm_of = replanner.replan(vm_of, s, active_next)
                # pad to a window multiple (repeat the last planned row, which
                # places every partition thanks to the activation floor) so
                # replans never create remainder-sized windows
                rem = (vm_of.shape[0] - s) % window
                if rem:
                    vm_of = np.vstack(
                        [vm_of, np.tile(vm_of[-1], (window - rem, 1))]
                    )
                replans += 1
                horizon = vm_of.shape[0]

            # never run past the plan: divergence inside a window is caught
            # at the next boundary, but an unplanned superstep never executes
            k = max(1, min(window, horizon - s, max_supersteps - s))
            rows = vm_of[s : s + k]

            # -- one engine window, one bulk counter pull --------------------
            wres = self.engine.run_window(state, k)
            host_syncs += 1
            state = wres.state
            steps = int(wres.n_supersteps[0]) - s

            # -- stage the executed supersteps' scheduled movement -----------
            # only supersteps that actually ran move state: a window tail past
            # convergence never migrates, so counted moves == billed moves.
            # The VM move is the *billed* (simulated cloud) migration; a
            # move whose VMs map onto different devices is tallied apart.
            for t in range(steps):
                row = rows[t]
                for i in np.flatnonzero(row >= 0):
                    j = int(row[i])
                    if prev_vm[i] == j:
                        continue
                    dev = device_of_vm(j, n_dev)
                    if 0 <= prev_dev[i] != dev:  # the shard crossed devices
                        device_moves += 1
                        device_move_bytes += int(self.partition_bytes[i])
                    if prev_vm[i] >= 0:
                        migrations += 1
                        migration_bytes += int(self.partition_bytes[i])
                        mig_events.append(
                            (
                                s + t,
                                j,
                                self.partition_bytes[i] / self.billing.move_bandwidth,
                            )
                        )
                    prev_vm[i] = j
                    prev_dev[i] = dev

            for t in range(steps):
                verts = wres.verts_processed[0, t].astype(np.float64)
                edges = wres.edges_examined[0, t].astype(np.float64)
                active_mask = verts > 0
                tau_row = self.tau_scale * (self.alpha * verts + self.beta * edges)
                tau_row = np.where(active_mask, tau_row, 0.0)
                taus.append(tau_row)
                vm_rows.append(np.where(active_mask, rows[t], -1))
                replanner.observe(tau_row)
            s += steps
            active_next = wres.part_active_next[0]
            done = bool(wres.done[0])
            residency.append(prev_dev.copy())

        # the final bulk pull
        dist = self.engine.gather_global(state.dist)[0]
        host_syncs += 1

        tau = np.vstack(taus) if taus else np.zeros((0, pg.n_parts))
        actual_tf = TimeFunction(tau)
        executed = Placement(
            strategy=plan.strategy + ("+replan" if replans else ""),
            tau=tau,
            vm_of=np.vstack(vm_rows) if vm_rows else np.zeros((0, pg.n_parts), np.int64),
            always_on=plan.always_on,
            pinned=plan.pinned,
        )
        mig_busy = None
        if mig_events:
            j_max = max(j for _, j, _ in mig_events) + 1
            mig_busy = np.zeros((s, j_max))
            for step, j, secs in mig_events:
                mig_busy[step, j] += secs
        cost = evaluate(executed, self.billing, migration_busy=mig_busy)
        return ExecutionReport(
            dist=dist,
            actual_tau=actual_tf,
            cost=cost,
            n_supersteps=s,
            n_migrations=migrations,
            migration_bytes=migration_bytes,
            replans=replans,
            host_syncs=host_syncs,
            window=window,
            wall_seconds=time.perf_counter() - t0,
            device_moves=device_moves,
            device_move_bytes=device_move_bytes,
            residency=(
                np.stack(residency)
                if residency
                else np.zeros((0, pg.n_parts), dtype=np.int64)
            ),
            mutations_applied=mutations_applied,
            repartition_moves=repartition_moves,
        )
