"""Billing simulator (paper s4.3 cost model + s6.2 metrics).

Given a Placement and a BillingModel, computes:

  * makespan T          = sum_s (superstep wall duration)
  * cost Gamma          = billed quanta * gamma, via the activation policy
  * Gamma_Min/Gamma_Max = the paper's analytic cost bounds
  * core-seconds        = sum_s duration_s * |Upsilon_s| (provisioned)
  * under-utilization   = provisioned core-secs - useful work
  * OPT-DM              = same placement, but each active partition is staged
    through shared storage: move-out at superstep end + move-in at start add
    to the hosting VM's busy time (and hence duration/makespan/billing).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.activation import plan_sessions
from repro_torch.core.placement import Placement

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class BillingModel:
    delta: float = 60.0  # billing quantum, seconds (1 core-min)
    gamma: float = 1.0  # cost per quantum
    activation_rule: str = "gap_le_delta"
    # data movement (OPT-DM): effective staging bandwidth VM <-> shared store
    move_bandwidth: float = 100e6  # bytes/s (paper: naive copy over GbE + store)
    move_skip_same_vm: bool = False  # beyond-paper: skip staging if VM unchanged


@dataclasses.dataclass(frozen=True)
class CostReport:
    strategy: str
    makespan: float
    t_min: float
    cost_quanta: int  # Gamma in quanta (core-mins at delta=60)
    cost: float  # Gamma * gamma
    gamma_min_quanta: int
    gamma_max_quanta: int
    core_secs: float
    useful_secs: float
    under_util_secs: float
    peak_vms: int
    total_vms: int
    vm_starts: int
    data_move_secs: float = 0.0
    migration_secs: float = 0.0  # elastic-executor partition moves (bytes/bw)

    @property
    def makespan_over_tmin(self) -> float:
        return self.makespan / self.t_min if self.t_min else math.inf


def evaluate(
    placement: Placement,
    model: BillingModel | None = None,
    *,
    data_movement: bool = False,
    partition_bytes: np.ndarray | None = None,
    migration_busy: np.ndarray | None = None,
) -> CostReport:
    """Bill a placement.  ``migration_busy`` is an optional ``[m, J']`` matrix
    of seconds each VM spends receiving migrated partition state per superstep
    (``partition_bytes / move_bandwidth``, produced by the elastic executor);
    it extends each receiving VM's busy time and therefore the superstep
    durations, makespan, and billed quanta."""
    model = model or BillingModel()
    tau = placement.tau
    m, n = tau.shape
    loads = placement.loads()  # [m, J]
    n_vms = loads.shape[1]
    migration_secs = 0.0
    if migration_busy is not None and migration_busy.size:
        if migration_busy.shape[0] != m:
            raise ValueError(
                f"migration_busy has {migration_busy.shape[0]} supersteps, "
                f"placement has {m}"
            )
        migration_secs = float(migration_busy.sum())
        # a migration target may be a VM no active partition ever ran on;
        # widen to the larger VM count and bill it for the transfer time
        j_all = max(n_vms, migration_busy.shape[1])
        wide = np.zeros((m, j_all))
        wide[:, : loads.shape[1]] = loads
        wide[:, : migration_busy.shape[1]] += migration_busy
        loads = wide
        n_vms = j_all

    move = np.zeros_like(loads)
    data_move_secs = 0.0
    if data_movement:
        assert partition_bytes is not None, "OPT-DM needs partition sizes"
        for s in range(m):
            for i in range(n):
                j = placement.vm_of[s, i]
                if j < 0:
                    continue
                stage = 2.0  # move-in at start + move-out at end
                if model.move_skip_same_vm:
                    prev_same = s > 0 and placement.vm_of[s - 1, i] == j
                    next_same = s + 1 < m and placement.vm_of[s + 1, i] == j
                    stage = (0.0 if prev_same else 1.0) + (0.0 if next_same else 1.0)
                move[s, j] += stage * partition_bytes[i] / model.move_bandwidth
        data_move_secs = float(move.sum())

    busy = loads + move
    if placement.always_on:
        # default strategy: all n VMs provisioned every superstep
        compute = tau.max(axis=1)
        t_min = float(compute.sum())
        # migration transfers extend the receiving VM's superstep, and hence
        # the barrier-synchronized duration (loads was widened above)
        durations = (
            np.maximum(compute, loads.max(axis=1)) if migration_secs else compute
        )
        makespan = float(durations.sum())
        core_secs = float(durations.sum() * n)
        useful = float(tau.sum())
        quanta = n * max(1, math.ceil(makespan / model.delta - _EPS))
        g_min = quanta
        g_max = quanta
        return CostReport(
            strategy=placement.strategy,
            makespan=makespan,
            t_min=t_min,
            cost_quanta=quanta,
            cost=quanta * model.gamma,
            gamma_min_quanta=g_min,
            gamma_max_quanta=g_max,
            core_secs=core_secs,
            useful_secs=useful,
            under_util_secs=core_secs - useful,
            peak_vms=n,
            total_vms=n,
            vm_starts=n,
            migration_secs=migration_secs,
        )

    durations = busy.max(axis=1) if n_vms else np.zeros(m)
    makespan = float(durations.sum())
    t_min = float(tau.max(axis=1).sum())

    sessions = plan_sessions(
        busy, durations, model.delta, rule=model.activation_rule
    )
    quanta = sessions.billed_quanta(model.delta)

    active_vms = (busy > 0).sum(axis=1)
    core_secs = float((durations * active_vms).sum())
    useful = float(tau.sum())

    # Gamma_Min: per-VM total busy time rounded up once (no restart penalty)
    g_min = 0
    for j in range(n_vms):
        t = float(busy[:, j].sum())
        if t > 0:
            g_min += max(1, math.ceil(t / model.delta - _EPS))
    # Gamma_Max: every active VM billed per superstep independently
    g_max = 0
    for s in range(m):
        if active_vms[s]:
            g_max += int(active_vms[s]) * max(
                1, math.ceil(durations[s] / model.delta - _EPS)
            )

    return CostReport(
        strategy=placement.strategy + ("-dm" if data_movement else ""),
        makespan=makespan,
        t_min=t_min,
        cost_quanta=quanta,
        cost=quanta * model.gamma,
        gamma_min_quanta=g_min,
        gamma_max_quanta=g_max,
        core_secs=core_secs,
        useful_secs=useful,
        under_util_secs=core_secs - useful,
        peak_vms=int(active_vms.max()) if m else 0,
        total_vms=n_vms,
        vm_starts=sessions.n_starts,
        data_move_secs=data_move_secs,
        migration_secs=migration_secs,
    )
