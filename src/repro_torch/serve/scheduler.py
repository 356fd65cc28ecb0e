"""Window-granular capacity scheduler for the traversal service.

Each window launch asks one question: how many VM slots should the coming
window's supersteps run on?  The answer combines the two signals the paper's
machinery already produces:

  * **Activity forecast** -- the executed tau prefix observed through
    ``OnlineReplanner``-style bookkeeping is extrapolated one window ahead
    by ``core.replan.extrapolate_tau`` (per-partition geometric activity
    decay + activation floor, optionally sketch-refined).  LPT packing of
    the forecast row over ``c`` VM slots estimates the superstep duration
    ``d(c)`` at each candidate capacity.
  * **Queue-length drift** -- following Ghaderi et al. (*Scheduling Storms
    and Streams in the Cloud*): capacity scales with the backlog, so the
    queue drifts toward empty whenever the arrival rate is inside the
    service's capacity region.  Here the drift term is
    ``ceil(queue_len * queue_weight)`` VM slots -- each ``1/queue_weight``
    queued queries pull one more VM into the window.

The decision rule is cost-greedy under a latency guard:

    ``c = clip(max(feasible, drift), min_vms, max_vms)``

where ``feasible`` is the *smallest* capacity whose predicted duration stays
within ``latency_stretch`` of full capacity (``d(c) <= latency_stretch *
d(max_vms)``) on **two** stress profiles: the one-window forecast row and
the per-partition *peak* observed row.  The peak guard is what makes the
stretch bound hold against forecast error -- a decaying extrapolation
systematically underestimates the mid-traversal frontier explosion, and a
capacity that only fits the underestimate saturates the service.  With an
empty queue the service therefore runs the cheapest capacity that keeps
per-window latency within the stretch bound even at peak load (this is what
keeps elastic p99 sojourn within ~``latency_stretch``x of a statically
provisioned service), and a growing queue ramps capacity toward ``max_vms``
until the backlog drains.  ``static_vms`` pins the decision -- the
statically provisioned baseline the benchmarks compare against.

Within a superstep, active partitions are assigned to the chosen VM slots
by deterministic LPT (longest-processing-time) packing -- the serving twin
of the per-superstep bin packers in ``core.placement`` (those choose the
bin *count* from a capacity bound; serving fixes the count and balances the
load).  Everything here is host-side numpy (the port's copy of
``repro.serve.scheduler``) -- no device, no wall clock.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.replan import ReplanConfig, extrapolate_tau
from repro_torch.core.timing import TimeFunction


def lpt_rows(tau_row: np.ndarray, n_vms: int) -> np.ndarray:
    """[P] VM slot per partition (-1 inactive): LPT onto ``n_vms`` slots.

    Deterministic: partitions sorted by descending tau (stable -- ties break
    by partition id), each placed on the currently least-loaded slot (ties
    by slot id), so the same tau row always yields the same assignment.
    """
    tau_row = np.asarray(tau_row, dtype=np.float64)
    if n_vms < 1:
        raise ValueError(f"n_vms must be >= 1, got {n_vms}")
    assign = np.full(tau_row.shape[0], -1, dtype=np.int64)
    active = np.flatnonzero(tau_row > 0)
    if active.size == 0:
        return assign
    order = active[np.argsort(-tau_row[active], kind="stable")]
    loads = np.zeros(n_vms, dtype=np.float64)
    for i in order:
        j = int(np.argmin(loads))
        assign[i] = j
        loads[j] += tau_row[i]
    return assign


def lpt_makespan(tau_row: np.ndarray, n_vms: int) -> float:
    """Predicted superstep duration: max slot load under ``lpt_rows``."""
    tau_row = np.asarray(tau_row, dtype=np.float64)
    assign = lpt_rows(tau_row, n_vms)
    active = assign >= 0
    if not active.any():
        return 0.0
    loads = np.zeros(n_vms, dtype=np.float64)
    np.add.at(loads, assign[active], tau_row[active])
    return float(loads.max())


@dataclasses.dataclass(frozen=True)
class CapacityDecision:
    """One window's capacity choice and the forecast behind it."""

    n_vms: int
    feasible_vms: int  # latency-guard component (cheapest within stretch)
    drift_vms: int  # Ghaderi backlog component
    predicted_secs: float  # forecast superstep duration at n_vms
    baseline_secs: float  # forecast superstep duration at max_vms


class CapacityScheduler:
    """Per-window VM capacity controller (see module docstring)."""

    def __init__(
        self,
        n_parts: int,
        *,
        min_vms: int = 1,
        max_vms: int = 8,
        latency_stretch: float = 2.0,
        queue_weight: float = 0.125,
        static_vms: int | None = None,
        config: ReplanConfig | None = None,
        sketch: TimeFunction | None = None,
    ):
        if not 1 <= min_vms <= max_vms:
            raise ValueError(
                f"need 1 <= min_vms <= max_vms, got {min_vms}..{max_vms}"
            )
        if latency_stretch < 1.0:
            raise ValueError(f"latency_stretch must be >= 1, got {latency_stretch}")
        self.n_parts = int(n_parts)
        self.min_vms = int(min_vms)
        self.max_vms = int(max_vms)
        self.latency_stretch = float(latency_stretch)
        self.queue_weight = float(queue_weight)
        self.static_vms = None if static_vms is None else int(static_vms)
        self.config = config or ReplanConfig()
        self.sketch = sketch
        self._rows: list[np.ndarray] = []
        self._peak = np.zeros(self.n_parts, dtype=np.float64)

    @property
    def observed(self) -> np.ndarray:
        """[s, P] executed tau prefix observed so far."""
        return (
            np.vstack(self._rows)
            if self._rows
            else np.zeros((0, self.n_parts))
        )

    def observe(self, tau_row: np.ndarray) -> None:
        """Append one executed tau row (the service feeds every superstep)."""
        row = np.asarray(tau_row, dtype=np.float64).reshape(-1)
        self._rows.append(row)
        np.maximum(self._peak, row, out=self._peak)

    def decide(self, queue_len: int, active_next: np.ndarray) -> CapacityDecision:
        """Choose the coming window's VM capacity (see module docstring)."""
        forecast = extrapolate_tau(
            self.observed, np.asarray(active_next, dtype=bool), 1,
            self.config, self.sketch,
        )[0]
        baseline = lpt_makespan(forecast, self.max_vms)
        if self.static_vms is not None:
            c = min(max(self.static_vms, self.min_vms), self.max_vms)
            return CapacityDecision(
                n_vms=c, feasible_vms=c, drift_vms=0,
                predicted_secs=lpt_makespan(forecast, c),
                baseline_secs=baseline,
            )
        feasible = self.max_vms
        slack = self.latency_stretch * (1 + 1e-12)
        f_bound = slack * baseline
        p_bound = slack * lpt_makespan(self._peak, self.max_vms)
        for c in range(self.min_vms, self.max_vms + 1):
            if (
                lpt_makespan(forecast, c) <= f_bound
                and lpt_makespan(self._peak, c) <= p_bound
            ):
                feasible = c
                break
        drift = int(math.ceil(max(0, queue_len) * self.queue_weight))
        n = min(self.max_vms, max(self.min_vms, feasible, drift))
        return CapacityDecision(
            n_vms=n, feasible_vms=feasible, drift_vms=drift,
            predicted_secs=lpt_makespan(forecast, n),
            baseline_secs=baseline,
        )
