"""Bounded admission queue for the traversal service (paper s4 workload).

``TraversalQuery`` is one request: run ``program`` from ``source`` and
report completion, optionally against a soft ``deadline`` (seconds of
simulated sojourn; the service counts misses but never drops on them).
The queue is the service's *only* admission point and implements classic
open-loop backpressure: ``offer`` refuses work beyond ``capacity`` (the
caller sees ``None`` and the rejection is counted -- a loss system, not an
unbounded buffer), and admitted queries are held in strict FIFO order
inside per-program *lanes* so that one program's burst can never starve or
reorder another's (the micro-batcher drains each lane independently --
queries of different programs cannot share an engine batch).

Re-admission (``requeue``) is the ``TraversalNotConverged`` path: a query
whose traversal hit the service's superstep cap is pushed back at the tail
of its lane with its partial state dropped.  Requeues bypass the capacity
bound deliberately -- the query already holds an admission slot
conceptually, and refusing it would turn backpressure into silent loss of
accepted work.

Everything here is host-side stdlib bookkeeping (the port's copy of
``repro.serve.queue``): no torch import, no wall clock -- arrival times are
supplied by the service's simulated clock, so queue state is a pure
function of the offered trace.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class TraversalQuery:
    """One traversal request: ``program`` from ``source``.

    ``program`` is a ``graph.program.VertexProgram`` (``None`` selects the
    service's default program); ``deadline`` is an optional soft latency
    target in simulated seconds from arrival.
    """

    source: int
    program: object | None = None
    deadline: float | None = None


def lane_key(query: TraversalQuery, default_key: str = "default") -> str:
    """The query's lane id: the program's canonical ``key`` coerced to str.

    Two queries share a lane -- and therefore may share an engine batch --
    only when their programs are identical under ``VertexProgram.key``
    (name + parameters), the same coercion the engine cache uses.
    """
    prog = query.program
    return default_key if prog is None else str(prog.key)


@dataclasses.dataclass(frozen=True)
class Admitted:
    """An admitted query with its service-side bookkeeping."""

    qid: int  # admission order, globally unique
    query: TraversalQuery
    arrival: float  # simulated seconds
    requeues: int = 0  # times re-admitted after hitting the superstep cap


class AdmissionQueue:
    """Bounded FIFO admission queue with per-program lanes.

    ``capacity`` bounds the total queued (not yet dispatched) queries across
    all lanes; ``offer`` returns the ``Admitted`` record or ``None`` when the
    bound is hit (backpressure -- the caller decides whether to retry).
    """

    def __init__(self, capacity: int, *, default_key: str = "default"):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.default_key = str(default_key)
        self._lanes: OrderedDict[str, deque[Admitted]] = OrderedDict()
        self._size = 0
        self._next_qid = 0
        self.admitted = 0
        self.rejected = 0
        self.requeued = 0
        self.peak_depth = 0

    def __len__(self) -> int:
        return self._size

    def lanes(self) -> Iterator[str]:
        """Lane keys in first-seen order (the service's round-robin order)."""
        return iter(self._lanes.keys())

    def depth(self, lane: str) -> int:
        q = self._lanes.get(lane)
        return 0 if q is None else len(q)

    def _push(self, lane: str, rec: Admitted) -> None:
        q = self._lanes.get(lane)
        if q is None:
            q = deque()
            self._lanes[lane] = q
        q.append(rec)
        self._size += 1
        self.peak_depth = max(self.peak_depth, self._size)

    def offer(self, query: TraversalQuery, now: float) -> Admitted | None:
        """Admit ``query`` at simulated time ``now``; ``None`` on backpressure."""
        if self._size >= self.capacity:
            self.rejected += 1
            return None
        rec = Admitted(qid=self._next_qid, query=query, arrival=float(now))
        self._next_qid += 1
        self._push(lane_key(query, self.default_key), rec)
        self.admitted += 1
        return rec

    def requeue(self, rec: Admitted) -> Admitted:
        """Re-admit an unconverged query at its lane's tail (partial state
        dropped by the caller).  Exempt from the capacity bound -- see the
        module docstring."""
        rec = dataclasses.replace(rec, requeues=rec.requeues + 1)
        self._push(lane_key(rec.query, self.default_key), rec)
        self.requeued += 1
        return rec

    def take(self, lane: str, k: int) -> list[Admitted]:
        """Pop up to ``k`` queries from ``lane``'s head, FIFO."""
        q = self._lanes.get(lane)
        if q is None:
            return []
        out = []
        while q and len(out) < k:
            out.append(q.popleft())
        self._size -= len(out)
        return out
