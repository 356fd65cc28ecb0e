"""Source micro-batcher: pack queued queries into the engine's fixed ``[S]``
batch axis, whatever the arrival pattern.

The port's copy of ``repro.serve.batcher``.  Where the JAX engine compiles
its window program once per distinct ``(S, k)``, the port's engine launches
the same kernels at every shape; the contract stays that the *physical*
batch shape never follows the arrival pattern, so one lane keeps one engine
(one entry of the per-graph cache) and every window of a lane launches the
relax kernel on ``[s_batch, E]`` candidates over the same layouts (the
kernel's per-layout tile split is found once).  Three mechanisms keep the
shape fixed:

  * **Cold start pads with repeated sources**: a batch opened with fewer than
    ``s_batch`` queries cycles the real sources into the remaining rows.
    Padding rows ("phantoms") duplicate a real row bit-for-bit, converge at
    exactly the same superstep, and are excluded from billing and reporting
    -- they ride the fixed-shape launch for free.
  * **Early retirement**: a row whose query converges mid-stream (per-row
    ``done`` flags / ``n_supersteps`` counters from ``WindowResult``) is
    released at the window boundary; its state needs no surgery -- an empty
    frontier contributes zero work -- so retirement is pure bookkeeping.
  * **Backfill at window boundaries**: freed rows are re-initialized from
    newly dequeued sources via ``TraversalEngine.backfill_rows`` -- one
    row scatter per boundary on the state's device, bit-identical to the row
    a fresh batch would carry.
    Rows released *unconverged* (the requeue path) are deactivated by the
    same scatter (source ``-1``: identity state, empty frontier) so dropped
    partial state cannot keep computing.

The batcher is one lane's worth of state: all rows in a batch share one
``VertexProgram`` (the admission queue's lane invariant).  Everything here
is host-side bookkeeping over numpy row indices; device work happens inside
the engine.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serve.queue import Admitted


class MicroBatcher:
    """Row allocator for one lane's fixed-shape engine batch.

    ``slots[i]`` holds the ``Admitted`` record whose query row ``i`` is
    computing, or ``None`` for a free row (phantom padding, retired, or
    deactivated).  ``state`` is the engine's device-resident
    ``WindowState``; ``last_nst`` mirrors the per-row cumulative superstep
    counters at the last committed boundary so the service can account the
    executed superstep delta per window.
    """

    def __init__(self, engine, s_batch: int):
        if s_batch < 1:
            raise ValueError(f"s_batch must be >= 1, got {s_batch}")
        self.engine = engine
        self.s_batch = int(s_batch)
        self.slots: list[Admitted | None] = [None] * self.s_batch
        self.state = None  # WindowState once started
        self.last_nst = np.zeros(self.s_batch, dtype=np.int64)
        # predicted next-superstep partition activity per row, refreshed from
        # each window's part_active_next (program-defined initial active set
        # for freshly backfilled rows)
        self.pact = np.zeros((self.s_batch, engine.pg.n_parts), dtype=bool)
        self._kills: set[int] = set()

    # -- row accounting ------------------------------------------------------

    @property
    def live_mask(self) -> np.ndarray:
        """[S] bool, rows currently computing a real query."""
        return np.array([s is not None for s in self.slots], dtype=bool)

    @property
    def n_live(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def free(self) -> int:
        """Rows available to backfill (every non-live row once started)."""
        return self.s_batch - self.n_live

    def active_next(self) -> np.ndarray:
        """[P] bool: partitions predicted active at the next superstep,
        unioned over live rows (the scheduler's forecast input)."""
        live = self.live_mask
        if not live.any():
            return np.zeros(self.engine.pg.n_parts, dtype=bool)
        return self.pact[live].any(axis=0)

    def _initial_pact(self, source: int) -> np.ndarray:
        return np.asarray(
            self.engine.program.initial_active_parts(self.engine.pg, [source]),
            dtype=bool,
        )

    # -- boundary transitions ------------------------------------------------

    def retire(self, row: int) -> Admitted:
        """Release a *converged* row (no surgery: its frontier is empty)."""
        rec = self.slots[row]
        if rec is None:
            raise ValueError(f"row {row} is not live")
        self.slots[row] = None
        self.pact[row] = False
        return rec

    def mark_kill(self, row: int) -> Admitted:
        """Release an *unconverged* row (requeue/drop path): the row is
        deactivated by the next ``admit`` surgery so its partial state
        cannot keep computing."""
        rec = self.retire(row)
        self._kills.add(int(row))
        return rec

    def admit(self, recs: list[Admitted]) -> None:
        """Fill free rows with dequeued queries (one surgery per boundary).

        Cold start (no state yet) initializes the full batch, cycling the
        real sources into padding rows; thereafter freed rows are backfilled
        in ascending row order and any still-unfilled kill rows are
        deactivated.  The physical batch shape never changes -- it is a
        function of ``(s_batch, window)`` only.
        """
        if len(recs) > (self.s_batch if self.state is None else self.free):
            raise ValueError(
                f"admitting {len(recs)} queries but only "
                f"{self.free} rows are free"
            )
        if self.state is None:
            if not recs:
                return
            srcs = [int(r.query.source) for r in recs]
            padded = [srcs[i % len(srcs)] for i in range(self.s_batch)]
            self.state = self.engine.init_state(
                np.asarray(padded, dtype=np.int64)
            )
            self.last_nst[:] = 0
            for i, rec in enumerate(recs):
                self.slots[i] = rec
                self.pact[i] = self._initial_pact(srcs[i])
            return
        fill_rows = [i for i, s in enumerate(self.slots) if s is None][: len(recs)]
        rows = fill_rows + sorted(self._kills - set(fill_rows))
        if not rows:
            return
        srcs = [int(r.query.source) for r in recs] + [-1] * (
            len(rows) - len(fill_rows)
        )
        self.state = self.engine.backfill_rows(self.state, rows, srcs)
        self.last_nst[rows] = 0
        for row, rec in zip(fill_rows, recs):
            self.slots[row] = rec
            self.pact[row] = self._initial_pact(int(rec.query.source))
        for row in rows[len(fill_rows):]:
            self.pact[row] = False
        self._kills.clear()

    def commit_window(self, wres) -> int:
        """Adopt a ``WindowResult``: carry its state, refresh the per-row
        activity forecast, and return the number of supersteps the window
        actually executed (max per-live-row counter delta)."""
        self.state = wres.state
        live = self.live_mask
        delta = np.asarray(wres.n_supersteps, dtype=np.int64) - self.last_nst
        steps = int(delta[live].max()) if live.any() else 0
        self.last_nst = np.asarray(wres.n_supersteps, dtype=np.int64).copy()
        self.pact = np.asarray(wres.part_active_next, dtype=bool).copy()
        return steps
