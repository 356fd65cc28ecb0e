"""Traversal-as-a-service: the paper's elastic placement under real load
(the port of ``repro.serve``; the engine dense or on a mesh, as
``engine_config`` says).

The subsystem turns the batch-oriented traversal stack into a serving front
end: a stream of ``TraversalQuery(source, program, deadline)`` requests is
admitted through a bounded queue with per-program lanes (``serve.queue``),
micro-batched into the engine's fixed ``[S]`` source axis (``serve.batcher``
-- the batch shape never follows the arrivals), run window by window at a
per-window VM capacity chosen from the activity forecast plus a
Ghaderi-style queue-drift rule (``serve.scheduler``), and billed through
the existing two-ledger ``CostReport`` split (``serve.service``).  The event
loop is simulated-clock only, so every run is deterministic and bit-for-bit
replayable: the same trace gives the same ``ServiceReport`` on the ``cuda``
and ``torch`` backends, and as in the JAX package.
"""

from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.queue import Admitted, AdmissionQueue, TraversalQuery, lane_key
from repro_torch.serve.scheduler import (
    CapacityDecision,
    CapacityScheduler,
    lpt_makespan,
    lpt_rows,
)
from repro_torch.serve.service import (
    QueryRecord,
    ServiceConfig,
    ServiceReport,
    TraversalService,
    poisson_trace,
)

__all__ = [
    "Admitted",
    "AdmissionQueue",
    "CapacityDecision",
    "CapacityScheduler",
    "MicroBatcher",
    "QueryRecord",
    "ServiceConfig",
    "ServiceReport",
    "TraversalQuery",
    "TraversalService",
    "lane_key",
    "lpt_makespan",
    "lpt_rows",
    "poisson_trace",
]
