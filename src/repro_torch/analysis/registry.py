"""What the analyzers analyze: the hot-path registry and the audit matrix
(the port of ``repro.analysis.registry``).

The JAX package traces a window into one jitted program, so its registry
names the functions traced into it.  In eager PyTorch a window is a host
loop that enqueues launches, and what stalls the card is a value read back
to the host between two launches.  ``HOT_PATH_FUNCTIONS`` names the
functions that run between two launches of a window, with the parameters
that arrive as device tensors; the AST lint (rule AL01) holds exactly these
to "no uncounted host read".  A read the engine counts goes through one of
the ``COUNTED_READS`` helpers, which the lint lets through and the window
auditor (JX01) holds to the counters.

``AUDIT_BACKENDS`` / ``AUDIT_MESH_WIDTH`` / ``AUDIT_MIRROR_DEGREE`` pin the
window auditor's matrix; ``TRANSFERS_PER_PULL`` is the written-down
relation between the engine's counted bulk pulls and the transfers they
make.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HotPathFn:
    """One hot-path function: file suffix + function name + tensor params."""

    file_suffix: str  # path suffix under src/repro_torch, e.g. "graph/traversal.py"
    name: str  # the def's name (unique within its file, nested defs included)
    array_params: tuple  # parameter names that arrive as device tensors
    note: str = ""


#: the functions that run between two launches of a window -- the AL01
#: registry (nested defs inside them are walked with them)
HOT_PATH_FUNCTIONS = (
    HotPathFn(
        "graph/traversal.py", "_window_impl", ("dist", "frontier", "nst0"),
        "the dense window: superstep loop, local closure, remote exchange",
    ),
    HotPathFn(
        "graph/traversal.py", "_launch", ("dist", "frontier", "nst0"),
        "one window on the dense or the mesh program",
    ),
    HotPathFn(
        "graph/traversal.py", "backfill_rows", ("state",),
        "serving row surgery at a window boundary",
    ),
    HotPathFn(
        "graph/mesh_exchange.py", "window", ("dist", "frontier", "nst0"),
        "one rank's mesh window",
    ),
    HotPathFn(
        "graph/deltas.py", "_reactivate_rows", ("dist", "frontier", "idx"),
        "delta-merge frontier reactivation",
    ),
    HotPathFn(
        "kernels/bfs_relax/ops.py", "relax_blockmap_call",
        ("row_ptr", "dst", "cand", "base"),
        "every value reduction of a window",
    ),
    HotPathFn(
        "kernels/bfs_relax/kernel.py", "__call__", ("row_ptr", "cand", "base"),
        "the relax kernel's launch wrapper",
    ),
    HotPathFn(
        "kernels/segment_sum/kernel.py", "__call__", ("ids", "vals"),
        "the segment-sum kernel's launch wrapper",
    ),
    HotPathFn(
        "kernels/flash_attention/kernel.py", "__call__", ("q", "k", "v"),
        "the flash kernel's launch wrapper",
    ),
    HotPathFn(
        "kernels/part_count/ops.py", "part_counts", ("x", "part_of"),
        "every partition counter of a window",
    ),
    HotPathFn(
        "kernels/part_count/kernel.py", "__call__", ("x", "part_of"),
        "the partition-counter kernel's launch wrapper",
    ),
)

#: the helpers through which a counted host read goes: (the file that
#: defines and calls it, the call as written there).  ``self._any`` counts
#: a loop condition in ``host_syncs``; ``_to_host`` is a bulk pull's
#: transfer; ``read_any`` counts a mesh loop condition in ``host_reads``.
#: In its own file, a call of that form is a counted read (its arguments
#: are still linted) and the helper's body is not linted as hot path.
COUNTED_READS = (
    ("graph/traversal.py", "self._any"),
    ("graph/traversal.py", "_to_host"),
    ("graph/mesh_exchange.py", "read_any"),
)

#: device-to-host transfers one counted bulk pull makes: ``run_window`` pulls
#: the window's counters as 7 tensors (``n_supersteps``, the three ``[S, k,
#: P]`` counters, ``inner_iters``, ``part_active_next``, ``done``) for one
#: ``bulk_pulls += 1``.  The JAX package's contract is one transfer a
#: window; until the pull is one transfer, the audit holds the port to 7.
TRANSFERS_PER_PULL = 7

#: backends every program is audited under; ``cuda`` only on a card
AUDIT_BACKENDS = ("torch", "cuda")

#: mesh width of the SPMD audits: 4 gloo ranks, as the reference's 4 abstract
#: devices (padded shard shapes then differ per rank)
AUDIT_MESH_WIDTH = 4

#: hub threshold of the mirrored mesh audits -- low enough that the default
#: audit graph has hubs (a zero-hub threshold would audit the unmirrored
#: window again)
AUDIT_MIRROR_DEGREE = 2
