"""``GraphSession``: one handle over a (mutating) graph and its engines, on
the dense engine (the port of ``repro.graph.session``).

A session owns the *current* ``PartitionedGraph`` plus one frozen
``EngineConfig`` and exposes the workflows that otherwise wire three
constructors by hand:

    session = open_session(pg, EngineConfig(device="cuda"))
    res = session.run(program, sources=[0, 7])          # full traversal
    state = session.init_state([0]); ...                # windowed traversal
    wres = session.run_window(state)
    state = session.apply_deltas(buf, state=wres.state) # window-boundary merge

``apply_deltas`` is the window-boundary mutation seam from ``graph.deltas``:
it collapses the buffer into a new graph, optionally runs the bounded
repartitioner (``core.repartition``), and carries any in-flight window state
exactly -- re-activating inserted-edge sources so a monotone traversal
continued on the merged graph converges to the mutated graph's fixpoint.
Deletes cannot be carried under (state must be None); stationary programs
cannot be carried at all.

Engines stay cached per graph instance (``traversal.get_engine``), so a
session is cheap to hold and swap: mutation replaces ``session.pg`` with the
new instance and the old engines are garbage once their queries drain.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.repartition import (
    RepartitionConfig,
    RepartitionResult,
    incremental_repartition,
)
from repro_torch.graph.config import EngineConfig, resolve_device
from repro_torch.graph.deltas import EdgeDeltaBuffer, merge_buffer, reactivate_sources
from repro_torch.graph.structs import PartitionedGraph
from repro_torch.graph.traversal import TraversalEngine, TraversalResult, get_engine


class GraphSession:
    """Facade over (current graph, engine config); see module docstring."""

    def __init__(
        self, pg: PartitionedGraph, config: EngineConfig | None = None
    ):
        self.pg = pg
        self.config = config or EngineConfig()
        resolve_device(self.config.device)  # a CUDA config without CUDA raises
        self.last_repartition: RepartitionResult | None = None

    # -- engines -------------------------------------------------------------

    def engine(self, program=None) -> TraversalEngine:
        """The cached engine for ``program`` on the session's current graph."""
        return get_engine(self.pg, program=program, config=self.config)

    # -- traversal -----------------------------------------------------------

    def run(self, program=None, sources=(0,)) -> TraversalResult:
        """One full batched traversal on the current graph."""
        return self.engine(program).run(list(sources))

    def init_state(self, sources, *, program=None):
        return self.engine(program).init_state(list(sources))

    def run_window(self, state, k: int | None = None, *, program=None):
        """Advance ``state`` by ``k`` supersteps (default: config.window)."""
        k = self.config.window if k is None else int(k)
        return self.engine(program).run_window(state, k)

    # -- mutation ------------------------------------------------------------

    def apply_deltas(
        self,
        buf: EdgeDeltaBuffer,
        *,
        state=None,
        program=None,
        repartition: RepartitionConfig | bool | None = None,
    ):
        """Merge a delta buffer at a window boundary; returns the carried
        ``state`` (or None when none was passed).

        The merge path: new graph and optional bounded repartition
        (``graph.deltas.merge_buffer``) -> exact state carry +
        inserted-source reactivation.  ``repartition=True`` uses a default
        ``RepartitionConfig``.
        """
        if state is not None:
            if buf.has_deletes:
                raise ValueError(
                    "cannot carry in-flight state across deletes: a delete "
                    "cannot be un-relaxed; finish or restart the query first"
                )
            prog = self.engine(program).program
            if getattr(prog, "stationary", False):
                raise ValueError(
                    "state carry across a merge is monotone-programs-only "
                    f"(got stationary {prog.key})"
                )

        self.pg, self.last_repartition = merge_buffer(self.pg, buf, repartition)
        if state is None:
            return None
        # dense state is in global vertex order, which the merge keeps
        return reactivate_sources(
            state, None, buf.inserts()[0], identity=self.engine(program).program.identity
        )

    def repartition(
        self, config: RepartitionConfig | None = None
    ) -> RepartitionResult:
        """Run one bounded repartition pass; adopt the improved map."""
        rep = incremental_repartition(
            self.pg, config=config or RepartitionConfig()
        )
        self.pg = rep.pg
        self.last_repartition = rep
        return rep

    # -- downstream handles --------------------------------------------------

    def executor(self, *, program=None, **kwargs):
        """An ``ElasticBSPExecutor`` on the current graph, config-threaded."""
        from repro_torch.core.elastic import ElasticBSPExecutor

        return ElasticBSPExecutor(
            self.pg, program=program, config=self.config, **kwargs
        )

    def gather_global(self, rows) -> np.ndarray:
        """Engine-layout state rows (a tensor or host numpy) in global
        vertex order on the host."""
        return self.engine().gather_global(rows)


def open_session(
    pg: PartitionedGraph, config: EngineConfig | None = None
) -> GraphSession:
    """The front door of the unified API: a session over ``pg``."""
    return GraphSession(pg, config)
