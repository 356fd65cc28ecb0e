"""Partition placement strategies (paper s5).

All strategies consume a TimeFunction ``tau[s, i]`` and emit a ``Placement``
with ``vm_of[s, i]`` = VM index hosting partition i in superstep s (-1 when
the partition is inactive and unplaced).  VM indices identify *physical* VM
slots across supersteps: VM j in superstep s and s+1 is the same machine if
retained by the activation policy.

  default  -- one exclusive VM per partition, all supersteps (s5.1)
  OPT      -- per-superstep bin packing solved exactly (branch & bound with
              FFD incumbent + Martello-Toth L2 lower bound); capacity
              tau_Max^s guarantees makespan == T_Min (s5.2)
  FFD      -- First Fit Decreasing heuristic for the same packing (s5.2)
  MF/P     -- Max-Fit with Pinning: no migration after first placement (s5.3)
  LA/P     -- Lookahead with Pinning: prefer VMs lightly loaded in the *next*
              superstep (forward rank) (s5.4)

Placement runs once per job on the controller -- a host-side planning
computation by design (the paper reports ~1 s for its largest input), so this
module is intentionally plain numpy/python rather than JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.core.timing import TimeFunction


class PackResult(NamedTuple):
    """Uniform bin-packer result: every packer returns exactly this shape.

    ``proven`` is True when ``n_bins`` is provably optimal (exact search
    completed within budget); heuristics always report False.
    """

    assign: np.ndarray  # [n_items] int64 bin index per item
    n_bins: int
    proven: bool

# Relative tolerance for capacity tests: tau values are float; an item equal
# to the remaining capacity must fit.
_EPS = 1e-9


def device_of_vm(vm, n_devices: int):
    """The single VM-slot -> mesh-device rule: round-robin ``vm % D``.
    Elementwise on arrays of VM slots.

    With at least as many devices as concurrently active VMs the mapping is
    injective and every scheduled VM move is a physical device move.  Every
    consumer (``Placement.device_row``, the elastic executor's shard
    placement and residency ledger) must route through this function so the
    plan, the physical placement, and the ledgers cannot disagree.
    """
    return vm % n_devices


@dataclasses.dataclass(frozen=True)
class Placement:
    strategy: str
    tau: np.ndarray  # [m, n]
    vm_of: np.ndarray  # [m, n] int64, -1 = inactive/unplaced this superstep
    always_on: bool = False  # default strategy: VMs billed for the whole run
    optimal: bool = False  # True when OPT proved optimality every superstep
    pinned: bool = False  # MF/P, LA/P: partitions never migrate

    @property
    def n_supersteps(self) -> int:
        return self.tau.shape[0]

    @property
    def n_parts(self) -> int:
        return self.tau.shape[1]

    @property
    def n_vms(self) -> int:
        return int(self.vm_of.max()) + 1 if (self.vm_of >= 0).any() else 0

    def device_row(self, s: int, n_devices: int) -> np.ndarray:
        """Map superstep ``s``'s VM row onto mesh devices.

        This is THE plan -> mesh bridge (see ``device_of_vm`` for the rule);
        inactive partitions stay ``-1``.
        """
        row = self.vm_of[s]
        return np.where(row >= 0, device_of_vm(row, n_devices), -1)

    def loads(self) -> np.ndarray:
        """[m, n_vms] cumulative active-partition time per VM per superstep."""
        m, j = self.n_supersteps, self.n_vms
        out = np.zeros((m, j), dtype=np.float64)
        for s in range(m):
            mask = self.vm_of[s] >= 0
            np.add.at(out[s], self.vm_of[s][mask], self.tau[s][mask])
        return out

    def vms_per_superstep(self) -> np.ndarray:
        """|Upsilon_s|: VMs with at least one active partition."""
        return (self.loads() > 0).sum(axis=1)

    def validate(self) -> None:
        """Invariants shared by every strategy.

        Raises ``ValueError`` naming the offending superstep/partition (a
        bare ``assert`` would be silently skipped under ``python -O``).
        """
        active = self.tau > 0
        unplaced = active & (self.vm_of < 0)
        if unplaced.any():
            s, i = (int(x) for x in np.argwhere(unplaced)[0])
            raise ValueError(
                f"{self.strategy}: active partition {i} is unplaced at "
                f"superstep {s} (tau={self.tau[s, i]:g}, vm={self.vm_of[s, i]})"
            )
        if self.pinned:
            # once placed, the mapping never changes
            for i in range(self.n_parts):
                vms = self.vm_of[:, i]
                placed_steps = np.flatnonzero(vms >= 0)
                if placed_steps.size and (vms[placed_steps] != vms[placed_steps[0]]).any():
                    bad = placed_steps[
                        np.flatnonzero(vms[placed_steps] != vms[placed_steps[0]])[0]
                    ]
                    raise ValueError(
                        f"{self.strategy}: pinned partition {i} migrates at "
                        f"superstep {int(bad)} (VM {int(vms[placed_steps[0]])} "
                        f"-> {int(vms[bad])})"
                    )


# ---------------------------------------------------------------------------
# Default (s5.1)
# ---------------------------------------------------------------------------


def default_placement(tf: TimeFunction) -> Placement:
    m, n = tf.tau.shape
    vm_of = np.tile(np.arange(n, dtype=np.int64), (m, 1))
    vm_of = np.where(tf.tau > 0, vm_of, -1)
    # inactive partitions still live on their VM, but carry no load; VMs are
    # billed for the full run via always_on.
    return Placement("default", tf.tau, vm_of, always_on=True)


# ---------------------------------------------------------------------------
# Bin packing core (OPT + FFD share it)
# ---------------------------------------------------------------------------


def _ffd_pack(sizes: np.ndarray, capacity: float) -> PackResult:
    """First-fit-decreasing heuristic (``proven`` is always False)."""
    order = np.argsort(-sizes, kind="stable")
    remaining: list[float] = []
    assign = np.full(sizes.shape[0], -1, dtype=np.int64)
    tol = _EPS * max(capacity, 1.0)
    for idx in order:
        sz = sizes[idx]
        for j, rem in enumerate(remaining):
            if rem >= sz - tol:
                assign[idx] = j
                remaining[j] = rem - sz
                break
        else:
            assign[idx] = len(remaining)
            remaining.append(capacity - sz)
    return PackResult(assign, len(remaining), False)


def _l2_lower_bound(sizes: np.ndarray, capacity: float) -> int:
    """Martello-Toth L2 lower bound for bin packing."""
    if sizes.size == 0:
        return 0
    best = int(np.ceil(sizes.sum() / capacity - _EPS))
    svals = np.sort(sizes)
    for k in np.unique(svals):
        if k > capacity / 2:
            break
        big = svals[svals > capacity - k]  # need own bins
        mid = svals[(svals > capacity / 2) & (svals <= capacity - k)]
        small = svals[(svals >= k) & (svals <= capacity / 2)]
        free = (capacity * mid.size - mid.sum())  # room left in mid bins
        overflow = max(0.0, small.sum() - free)
        lb = big.size + mid.size + int(np.ceil(overflow / capacity - _EPS))
        best = max(best, lb)
    return best


def _exact_pack(
    sizes: np.ndarray, capacity: float, node_budget: int = 200_000
) -> PackResult:
    """Branch & bound bin packing.

    FFD provides the incumbent; nodes branch an item into each distinct-
    remaining-capacity open bin or one new bin.  On budget exhaustion the
    incumbent is returned (never worse than FFD) with ``proven=False``.
    """
    n = sizes.shape[0]
    if n == 0:
        return PackResult(np.empty(0, dtype=np.int64), 0, True)
    tol = _EPS * max(capacity, 1.0)
    order = np.argsort(-sizes, kind="stable")
    sorted_sizes = sizes[order]
    best_assign, best_bins, _ = _ffd_pack(sizes, capacity)
    lb_root = _l2_lower_bound(sizes, capacity)
    if best_bins == lb_root:
        return PackResult(best_assign, best_bins, True)

    suffix_sum = np.concatenate([np.cumsum(sorted_sizes[::-1])[::-1], [0.0]])
    nodes = 0
    exhausted = False
    cur_assign = np.full(n, -1, dtype=np.int64)

    def dfs(k: int, remaining: list[float]) -> None:
        nonlocal best_assign, best_bins, nodes, exhausted
        if exhausted:
            return
        nodes += 1
        if nodes > node_budget:
            exhausted = True
            return
        if k == n:
            if len(remaining) < best_bins:
                best_bins = len(remaining)
                ba = np.full(n, -1, dtype=np.int64)
                ba[order] = cur_assign[:n]
                best_assign = ba
            return
        used = len(remaining)
        # bound: bins used + L2 of remaining items packed into fresh bins,
        # relaxed by the total free capacity of open bins
        free = sum(remaining)
        need = suffix_sum[k] - free
        lb = used + max(0, int(np.ceil(need / capacity - _EPS)))
        if lb >= best_bins:
            return
        sz = sorted_sizes[k]
        tried: set[float] = set()
        for j, rem in enumerate(remaining):
            if rem >= sz - tol:
                key = round(rem, 12)
                if key in tried:  # symmetry: identical bins are equivalent
                    continue
                tried.add(key)
                remaining[j] = rem - sz
                cur_assign[k] = j
                dfs(k + 1, remaining)
                remaining[j] = rem
        if used + 1 < best_bins:  # open a new bin
            remaining.append(capacity - sz)
            cur_assign[k] = used
            dfs(k + 1, remaining)
            remaining.pop()
        cur_assign[k] = -1

    dfs(0, [])
    return PackResult(best_assign, best_bins, not exhausted)


def _per_superstep_packing(
    tf: TimeFunction,
    packer: Callable[[np.ndarray, float], PackResult],
    name: str,
) -> tuple[np.ndarray, bool]:
    m, n = tf.tau.shape
    vm_of = np.full((m, n), -1, dtype=np.int64)
    all_optimal = True
    for s in range(m):
        active = np.flatnonzero(tf.tau[s] > 0)
        if active.size == 0:
            continue
        sizes = tf.tau[s][active]
        cap = float(sizes.max())
        result = packer(sizes, cap)
        all_optimal &= result.proven
        vm_of[s, active] = result.assign
    return vm_of, all_optimal


def ffd_placement(tf: TimeFunction) -> Placement:
    vm_of, _ = _per_superstep_packing(tf, _ffd_pack, "ffd")
    return Placement("ffd", tf.tau, vm_of)


def opt_placement(tf: TimeFunction, *, node_budget: int = 200_000) -> Placement:
    vm_of, proven = _per_superstep_packing(
        tf, lambda s, c: _exact_pack(s, c, node_budget), "opt"
    )
    return Placement("opt", tf.tau, vm_of, optimal=proven)


# ---------------------------------------------------------------------------
# Pinning strategies (s5.3, s5.4)
# ---------------------------------------------------------------------------


def _pinned_placement(tf: TimeFunction, *, lookahead: bool) -> Placement:
    m, n = tf.tau.shape
    tau = tf.tau
    vm_of = np.full((m, n), -1, dtype=np.int64)
    pin: dict[int, int] = {}  # partition -> VM
    n_vms = 0

    for s in range(m):
        active = np.flatnonzero(tau[s] > 0)
        if active.size == 0:
            continue
        # pinned partitions retain their mapping
        load = np.zeros(n_vms, dtype=np.float64)
        unpinned = []
        for i in active:
            if i in pin:
                vm_of[s, i] = pin[i]
                load[pin[i]] += tau[s, i]
            else:
                unpinned.append(i)
        # tau_Max^s accounts for the largest partition AND the largest pinned
        # VM load (paper s5.3 redefinition)
        tau_max_s = max(
            float(tau[s][active].max()),
            float(load.max()) if load.size else 0.0,
        )
        tol = _EPS * max(tau_max_s, 1.0)
        # place unpinned partitions, largest first ("current rank")
        unpinned.sort(key=lambda i: -tau[s, i])
        for i in unpinned:
            sz = tau[s, i]
            placed = -1
            if n_vms:
                cap = tau_max_s - load[:n_vms]
                if lookahead:
                    # forward rank: ascending load in next superstep
                    nxt = np.zeros(n_vms, dtype=np.float64)
                    if s + 1 < m:
                        for p, j in pin.items():
                            nxt[j] += tau[s + 1, p]
                    for j in np.argsort(nxt, kind="stable"):
                        if cap[j] >= sz - tol:
                            placed = int(j)
                            break
                else:
                    # max fit: single VM with the largest available capacity
                    j = int(np.argmax(cap))
                    if cap[j] >= sz - tol:
                        placed = j
            if placed < 0:
                placed = n_vms
                n_vms += 1
                load = np.append(load, 0.0)
            load[placed] += sz
            pin[int(i)] = placed
            vm_of[s, i] = placed

    name = "lap" if lookahead else "mfp"
    return Placement(name, tau, vm_of, pinned=True)


def mfp_placement(tf: TimeFunction) -> Placement:
    return _pinned_placement(tf, lookahead=False)


def lap_placement(tf: TimeFunction) -> Placement:
    return _pinned_placement(tf, lookahead=True)


STRATEGIES: dict[str, Callable[[TimeFunction], Placement]] = {
    "default": default_placement,
    "opt": opt_placement,
    "ffd": ffd_placement,
    "mfp": mfp_placement,
    "lap": lap_placement,
}
