"""VM activation strategy (paper s5.2 "Activation Strategy").

Billing rounds every VM session up to the quantum delta, so terminating a VM
during a short idle gap and restarting it costs more than keeping it running.
Given the a-priori placement schedule, the gap lengths are known at launch
time, so the keep/terminate decision is static.

Rules:
  * ``"gap_le_delta"`` (paper): keep a VM through an idle gap iff the gap is
    at most one billing quantum (the paper's 3-superstep example).
  * ``"exact_greedy"`` (beyond-paper): compare the exact quantum cost of
    keeping vs stop+restart for each gap and keep iff not more expensive.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class VMSessions:
    """Per-VM billing sessions: list of (uptime_seconds) per session."""

    sessions: list[list[float]]  # sessions[j] = [dur0, dur1, ...]
    n_starts: int

    def billed_quanta(self, delta: float) -> int:
        q = 0
        for durs in self.sessions:
            for d in durs:
                q += max(1, math.ceil(d / delta - _EPS))
        return q


def plan_sessions(
    busy_time: np.ndarray,  # [m, J] seconds VM j is busy in superstep s
    durations: np.ndarray,  # [m] wall duration of each superstep
    delta: float,
    *,
    rule: str = "gap_le_delta",
) -> VMSessions:
    """Split each VM's life into billing sessions using the activation rule.

    A VM is *busy* in superstep s when it hosts an active partition; while
    busy it is up for the whole superstep (BSP barrier), i.e. ``durations[s]``
    seconds.  Idle gaps between busy spans are bridged (VM retained, billed
    for the gap) or cut (VM terminated, restarted at the next busy superstep).
    """
    m, n_vms = busy_time.shape
    sessions: list[list[float]] = []
    n_starts = 0
    for j in range(n_vms):
        busy_steps = np.flatnonzero(busy_time[:, j] > 0)
        if busy_steps.size == 0:
            sessions.append([])
            continue
        vm_sessions: list[float] = []
        cur = 0.0
        prev = None
        for s in busy_steps:
            if prev is None:
                cur = durations[s]
                n_starts += 1
                prev = s
                continue
            gap = float(durations[prev + 1 : s].sum())
            if _keep_through_gap(cur, gap, delta, rule):
                cur += gap + durations[s]
            else:
                vm_sessions.append(cur)
                cur = durations[s]
                n_starts += 1
            prev = s
        vm_sessions.append(cur)
        sessions.append(vm_sessions)
    return VMSessions(sessions=sessions, n_starts=n_starts)


def _keep_through_gap(consumed: float, gap: float, delta: float, rule: str) -> bool:
    if gap <= _EPS:
        return True
    if rule == "always_stop":  # reference bound for tests
        return False
    if rule == "always_keep":  # reference bound for tests
        return True
    if rule == "gap_le_delta":
        return gap <= delta + _EPS
    if rule == "exact_greedy":
        # keep: future billing continues from consumed+gap;
        # stop: round up now, future session starts fresh.
        keep_quanta = math.ceil((consumed + gap) / delta - _EPS)
        stop_quanta = math.ceil(consumed / delta - _EPS)  # + fresh session later
        # keeping is free when it does not add quanta beyond what stopping
        # would bill anyway; fresh sessions bill at least one quantum later.
        return keep_quanta <= stop_quanta + 1
    raise ValueError(f"unknown activation rule: {rule}")
