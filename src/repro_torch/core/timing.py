"""The time function A : P_i x s -> tau_i^s (paper s4.3).

``tau[s, i]`` is the compute seconds partition ``P_i`` needs in superstep
``s`` on one exclusive VM; 0 means inactive.  Instances come from either

  * a BSP execution trace (``from_trace``) -- the paper's evaluation input, or
  * the metagraph a-priori model (``repro_torch.core.metagraph``).

Work counters are converted to seconds with a calibrated linear cost model
``tau = alpha * vertices_processed + beta * edges_examined`` (the analytical
model of the paper's ref [6]).  ``scaled_to_tmin`` rescales a trace so the
theoretical-minimum makespan matches a target -- used to put synthetic-graph
traces on the paper's absolute time scale (their makespans are 21-33 s
against a delta = 60 s billing quantum, which is what makes elasticity pay).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Default calibration: ~2e-7 s/vertex, ~5e-8 s/edge (~20M edges/s/core), the
# regime of a JVM-based subgraph engine on 2013-era cores (paper's AMD 3380).
DEFAULT_ALPHA = 2.0e-7
DEFAULT_BETA = 5.0e-8


@dataclasses.dataclass(frozen=True)
class TimeFunction:
    tau: np.ndarray  # [m, n] float64 seconds; 0 == inactive

    def __post_init__(self):
        assert self.tau.ndim == 2
        assert (self.tau >= 0).all()

    @property
    def n_supersteps(self) -> int:
        return self.tau.shape[0]

    @property
    def n_parts(self) -> int:
        return self.tau.shape[1]

    @property
    def active(self) -> np.ndarray:
        return self.tau > 0

    def tau_max(self) -> np.ndarray:
        """[m] the per-superstep max single-partition time."""
        return self.tau.max(axis=1)

    def t_min(self) -> float:
        """Theoretical minimum makespan T_Min = sum_s max_i tau_i^s."""
        return float(self.tau_max().sum())

    def total_work(self) -> float:
        return float(self.tau.sum())

    @classmethod
    def from_trace(
        cls,
        trace,
        *,
        alpha: float = DEFAULT_ALPHA,
        beta: float = DEFAULT_BETA,
    ) -> "TimeFunction":
        tau = alpha * trace.verts_processed + beta * trace.edges_examined
        tau = np.where(trace.active, tau, 0.0)
        return cls(tau.astype(np.float64))

    def scaled_to_tmin(self, target_seconds: float) -> "TimeFunction":
        t = self.t_min()
        assert t > 0
        return TimeFunction(self.tau * (target_seconds / t))

    @classmethod
    def concat(cls, *parts: "TimeFunction | np.ndarray") -> "TimeFunction":
        """Stack time functions (or raw ``[m, n]`` rows) along supersteps.

        Used by the online re-planner to splice an observed prefix onto an
        extrapolated remaining horizon before re-running a strategy.
        """
        rows = [p.tau if isinstance(p, TimeFunction) else np.asarray(p) for p in parts]
        n_parts = {r.shape[1] for r in rows}
        if len(n_parts) > 1:
            raise ValueError(f"partition counts differ across parts: {sorted(n_parts)}")
        return cls(np.vstack(rows).astype(np.float64))

    def decay_rates(self, *, default: float = 0.7, clip: tuple[float, float] = (0.05, 1.25)) -> np.ndarray:
        """[n] per-partition activity decay: ratio of the last two positive
        tau values of each partition, clipped to ``clip`` (``default`` when a
        partition has fewer than two active supersteps).  This is the
        one-parameter-per-partition activity model the online re-planner
        extrapolates with (cf. the meta-graph activity sketch)."""
        m, n = self.tau.shape
        out = np.full(n, default, dtype=np.float64)
        for i in range(n):
            nz = np.flatnonzero(self.tau[:, i] > 0)
            if nz.size >= 2:
                out[i] = self.tau[nz[-1], i] / self.tau[nz[-2], i]
        return np.clip(out, clip[0], clip[1])
