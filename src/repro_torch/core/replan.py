"""Online re-planning for the elastic executor (paper s7 future work).

The port's copy of ``repro.core.replan``: host-side numpy, unchanged.

The a-priori plan comes from a *prediction* of the time function; when the
actually-active partition set diverges from it mid-run (or the traversal
outlives the planned horizon), the executor asks this module for a fresh
schedule covering the **entire remaining horizon** -- not a single patched
row.  The flow at a placement point ``s``:

  1. ``observe`` the executed tau rows (the pulled counter window converted
     through the calibrated cost model) -- the observed ``TimeFunction``
     prefix grows monotonically.
  2. Extrapolate the remaining horizon from per-partition *activity decay*:
     each partition's future tau decays geometrically from its last observed
     level at its own fitted rate (``TimeFunction.decay_rates``), and every
     partition additionally carries a small activation floor so that
     not-yet-active partitions (which may still be reached by remote
     messages) stay *placed* in the replanned schedule -- one observed
     divergence therefore triggers exactly one replan, not one per superstep.
  3. Run the placement strategy over observed-prefix + extrapolation and
     splice ``newplan.vm_of[s:]`` (the full multi-superstep remainder) onto
     the executed prefix.

Without a strategy the fallback extends the schedule by pinning the active
partitions to VMs 0..A-1 for the whole remaining horizon.

When the launch-time **metagraph sketch** is available (the predicted
TimeFunction from ``core.metagraph.predict_time_function``), it stands in
for the observed prefix wherever the prefix is too short to fit from:
a partition with fewer than two observed active supersteps takes its decay
rate from the sketch's predicted activity series instead of the global
default, and the activation floor is scaled per partition by the sketch's
predicted weight (a partition the sketch expects to run hot keeps a larger
placed-when-idle prior).  With no sketch the behavior is exactly the
observed-prefix fit.

Knobs (``ReplanConfig``): ``min_horizon`` / ``horizon_pad`` bound how far the
extrapolation looks; ``decay_default`` / ``decay_clip`` parameterize the
per-partition geometric model; ``activation_floor`` is the idle-partition
activity prior (as a fraction of the mean observed active tau);
``sketch_rel_clip`` bounds the sketch-derived per-partition floor scaling.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.core.placement import Placement
from repro_torch.core.timing import TimeFunction


@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    min_horizon: int = 8  # never splice fewer future rows than this
    horizon_pad: int = 4  # slack past the original plan's remaining length
    max_horizon: int = 1024
    decay_default: float = 0.7
    decay_clip: tuple[float, float] = (0.05, 1.25)
    activation_floor: float = 0.05  # idle-partition prior, x mean active tau
    eps_frac: float = 1e-3  # decay horizon cutoff, x mean active tau
    sketch_rel_clip: tuple[float, float] = (0.1, 10.0)  # floor scale bounds

    @classmethod
    def for_program(cls, program) -> "ReplanConfig":
        """Extrapolation defaults matched to the vertex program's shape.

        Traversals get the geometric activity-decay fit; stationary programs
        (``program.stationary``) hold every partition at its observed level
        -- their tau is flat until the budget ends, so a decaying
        extrapolation would spuriously shrink the replanned VM pool.
        """
        if getattr(program, "stationary", False):
            return cls(decay_default=1.0, decay_clip=(0.5, 1.25))
        return cls()


def _mean_positive(tau: np.ndarray) -> float:
    pos = tau > 0
    return float(tau[pos].mean()) if pos.any() else 0.0


def _fit_rates(
    observed: np.ndarray,
    config: ReplanConfig,
    sketch: TimeFunction | None,
) -> np.ndarray:
    """Per-partition decay rates: observed-prefix fit where the prefix holds
    at least two active supersteps, metagraph-sketch fit where only the
    sketch does, ``decay_default`` otherwise."""
    n_parts = observed.shape[1]
    rates = (
        TimeFunction(observed).decay_rates(
            default=config.decay_default, clip=config.decay_clip
        )
        if observed.shape[0]
        else np.full(n_parts, config.decay_default)
    )
    if sketch is not None:
        if sketch.n_parts != n_parts:
            raise ValueError(
                f"sketch has {sketch.n_parts} partitions, expected {n_parts}"
            )
        obs_fit = (observed > 0).sum(axis=0) >= 2
        sk_fit = (sketch.tau > 0).sum(axis=0) >= 2
        sk_rates = sketch.decay_rates(
            default=config.decay_default, clip=config.decay_clip
        )
        rates = np.where(~obs_fit & sk_fit, sk_rates, rates)
    return rates


def _activation_floor(
    mean_pos: float, n_parts: int, config: ReplanConfig, sketch: TimeFunction | None
) -> np.ndarray:
    """[P] placed-when-idle prior: uniform without a sketch, scaled by each
    partition's predicted weight (relative mean active tau) with one."""
    base = np.full(n_parts, config.activation_floor * mean_pos)
    if sketch is None:
        return base
    sk_mean = _mean_positive(sketch.tau)
    if sk_mean <= 0:
        return base
    per_part = np.array(
        [_mean_positive(sketch.tau[:, i]) for i in range(n_parts)]
    )
    rel = np.where(per_part > 0, per_part / sk_mean, 1.0)
    lo, hi = config.sketch_rel_clip
    return base * np.clip(rel, lo, hi)


def extrapolate_tau(
    observed: np.ndarray,
    active_next: np.ndarray,
    horizon: int,
    config: ReplanConfig = ReplanConfig(),
    sketch: TimeFunction | None = None,
) -> np.ndarray:
    """Predict ``[horizon, P]`` future tau rows from the observed prefix.

    Partitions active at the next superstep start from their last observed
    positive tau (mean active tau if never seen) and decay at their fitted
    per-partition rate; every partition is floored at the activation prior so
    the resulting plan keeps all partitions placed.  ``sketch`` (the
    metagraph-predicted TimeFunction) refines both the rates and the floor
    for partitions the observed prefix says too little about.
    """
    observed = np.asarray(observed, dtype=np.float64)
    n_parts = observed.shape[1]
    mean_pos = _mean_positive(observed)
    if mean_pos == 0.0:
        sk_mean = _mean_positive(sketch.tau) if sketch is not None else 0.0
        mean_pos = sk_mean if sk_mean > 0 else 1.0
    rates = _fit_rates(observed, config, sketch)
    last = np.zeros(n_parts)
    for i in range(n_parts):
        nz = np.flatnonzero(observed[:, i] > 0)
        if nz.size:
            last[i] = observed[nz[-1], i]
    base = np.where(
        np.asarray(active_next, dtype=bool),
        np.where(last > 0, last, mean_pos),
        0.0,
    )
    floor = _activation_floor(mean_pos, n_parts, config, sketch)
    out = np.zeros((horizon, n_parts))
    cur = base
    for t in range(horizon):
        out[t] = np.maximum(cur, floor)
        cur = cur * rates
    return out


def decay_horizon(
    observed: np.ndarray,
    active_next: np.ndarray,
    config: ReplanConfig = ReplanConfig(),
    sketch: TimeFunction | None = None,
) -> int:
    """Supersteps until every active partition's extrapolated tau decays
    below ``eps_frac`` x mean active tau (the activity-death horizon)."""
    observed = np.asarray(observed, dtype=np.float64)
    pos = observed > 0
    if not pos.any():
        return config.min_horizon
    mean_pos = float(observed[pos].mean())
    eps = config.eps_frac * mean_pos
    rates = _fit_rates(observed, config, sketch)
    h = config.min_horizon
    for i in np.flatnonzero(np.asarray(active_next, dtype=bool)):
        nz = np.flatnonzero(observed[:, i] > 0)
        level = observed[nz[-1], i] if nz.size else mean_pos
        if level <= eps:
            continue
        if rates[i] >= 1.0:  # not decaying: bounded by max_horizon below
            h = config.max_horizon
            break
        h = max(h, int(math.ceil(math.log(eps / level) / math.log(rates[i]))))
    return min(h, config.max_horizon)


class OnlineReplanner:
    """Maintains the observed TimeFunction prefix and splices full-horizon
    re-plans into a running schedule (see module docstring)."""

    def __init__(
        self,
        n_parts: int,
        strategy_fn: Callable[[TimeFunction], Placement] | None = None,
        config: ReplanConfig = ReplanConfig(),
        sketch: TimeFunction | None = None,
    ):
        self.n_parts = int(n_parts)
        self.strategy_fn = strategy_fn
        self.config = config
        self.sketch = sketch
        self._rows: list[np.ndarray] = []

    @property
    def observed(self) -> np.ndarray:
        """[s, P] executed tau prefix observed so far."""
        return (
            np.vstack(self._rows)
            if self._rows
            else np.zeros((0, self.n_parts))
        )

    def observe(self, tau_rows: np.ndarray) -> None:
        """Append executed tau rows ([P] or [t, P]) to the observed prefix."""
        rows = np.atleast_2d(np.asarray(tau_rows, dtype=np.float64))
        for r in rows:
            self._rows.append(r)

    def reprime(
        self, part_activity: np.ndarray, *, horizon: int | None = None
    ) -> None:
        """Replace the metagraph sketch with a prior built from *fresh*
        per-partition activity (``RepartitionResult.part_activity``, tau
        units).

        After a delta merge or a repartition pass the construction-time
        sketch describes a graph that no longer exists; everywhere the
        sketch stands in for a too-short observed prefix (decay rates,
        activation floors) it would feed the strategy stale weights.  The
        synthetic replacement decays each partition's fresh activity at the
        config default rate over ``horizon`` rows -- at least two positive
        rows per active partition, so ``_fit_rates`` can fit from it.  The
        observed prefix is deliberately untouched: it records what actually
        executed, and ``replan`` asserts its length against the superstep
        counter.
        """
        act = np.asarray(part_activity, dtype=np.float64)
        if act.shape != (self.n_parts,):
            raise ValueError(
                f"part_activity has shape {act.shape}, "
                f"expected ({self.n_parts},)"
            )
        h = max(2, int(horizon or self.config.min_horizon))
        decay = min(self.config.decay_default, self.config.decay_clip[1])
        decay = max(decay, self.config.decay_clip[0])
        steps = decay ** np.arange(h, dtype=np.float64)
        self.sketch = TimeFunction(np.clip(act, 0.0, None)[None, :] * steps[:, None])

    def replan(
        self, vm_of: np.ndarray, s: int, active_next: np.ndarray
    ) -> np.ndarray:
        """New full schedule: executed prefix ``vm_of[:s]`` + a re-planned
        remainder covering the whole extrapolated horizon (>= min_horizon
        rows, so one divergence costs one replan, not one per later
        superstep).  Every active partition carries the activation floor,
        so spliced rows keep all reachable partitions placed."""
        cfg = self.config
        observed = self.observed
        if observed.shape[0] != s:
            raise ValueError(
                f"observed prefix has {observed.shape[0]} rows, expected {s}"
            )
        active_next = np.asarray(active_next, dtype=bool)
        horizon = max(
            decay_horizon(observed, active_next, cfg, self.sketch),
            vm_of.shape[0] - s + cfg.horizon_pad,
            cfg.min_horizon,
        )
        horizon = min(horizon, cfg.max_horizon)
        if self.strategy_fn is None:
            # fallback: pin the active partitions to VMs 0..A-1 throughout
            row = np.full(self.n_parts, -1, dtype=np.int64)
            actives = np.flatnonzero(active_next)
            row[actives] = np.arange(actives.size)
            return np.vstack([vm_of[:s], np.tile(row, (horizon, 1))])
        future = extrapolate_tau(observed, active_next, horizon, cfg, self.sketch)
        newplan = self.strategy_fn(TimeFunction.concat(observed, future))
        return np.vstack([vm_of[:s], newplan.vm_of[s:]])
