"""repro_torch.analysis: static and run-time guarantees for the port's hot
path (the port of ``repro.analysis``).

Two layers over one Finding record:

- **window auditor** (:mod:`repro_torch.analysis.trace_audit`, rules
  JX01-JX05): runs every builtin ``VertexProgram`` through the dense
  ``TraversalEngine`` window and, on gloo ranks, the mesh window, records
  each window's op log (``TorchDispatchMode``) and each rank's ordered
  collectives, and checks them against the engine's own counters and
  declarations: host reads and transfers against ``host_syncs`` /
  ``bulk_pulls``, collective balance against ``collective_signature()``,
  launch grids and launches, layout-cache keys and builds, reduction
  identities -- and, on a card, each kernel wrapper launched into poisoned
  memory (AL03's intent).
- **AST lint** (:mod:`repro_torch.analysis.lint`, rules AL01-AL05):
  uncounted host reads on the hot path, bounded caches, tobytes cache keys,
  unused imports.

``python -m repro_torch.analysis`` (lint + full audit, on the card unless
``--device cpu``; exit 0 iff clean) or ``--fixtures`` (the known-bad corpus
in :mod:`repro_torch.analysis.fixtures` must be 100% flagged).
"""

from repro_torch.analysis.findings import RULES, Finding, render
from repro_torch.analysis.lint import lint_paths, lint_source

__all__ = [
    "RULES",
    "Finding",
    "audit_tree",
    "lint_paths",
    "lint_source",
    "render",
]


def __getattr__(name):
    # the AST layer imports nothing but the standard library; the window
    # auditor (engine, kernels, ranks) loads on first touch
    if name == "audit_tree":
        from repro_torch.analysis.trace_audit import audit_tree

        return audit_tree
    raise AttributeError(name)
