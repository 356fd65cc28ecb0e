"""Structured findings: the one record type both analysis layers emit
(the port of ``repro.analysis.findings``).

A finding names a rule (``RULES``), the artifact it fired on (a ``file:line``
for the AST lint, an audit label like ``mesh/bfs/torch/d4`` for the window
auditor), and a message.  ``python -m repro_torch.analysis`` renders findings
one per line and exits non-zero iff any exist.

The rule ids are the JAX package's, so a finding maps one to one onto the
reference's; each invariant is worded for eager PyTorch and hand-written
CUDA, where a window is a host loop of launches and not one traced program.
"""

from __future__ import annotations

import dataclasses

#: rule id -> one-line invariant
RULES = {
    # layer 1: the window auditor (run time, per program x backend x engine)
    "JX01": "the host reads and device-to-host transfers of a window are exactly "
    "the engine's counted host_syncs and bulk_pulls (TRANSFERS_PER_PULL a "
    "pull); no data-dependent-shape op on the hot path",
    "JX02": "mesh collectives balanced: every rank's ordered collective log "
    "equal, per-superstep counts per collective_signature(), the window "
    "epilogue as declared, every loop condition read from an all_reduce",
    "JX03": "every launch grid dimension >= 1 (kernels.build.check_grid before "
    "every launch); backend 'cuda' launches the relax kernel, 'torch' never",
    "JX04": "layout cache keys canonical (no dtype/shape-blind aliasing); "
    "revisiting a placement or a window length builds no layout again",
    "JX05": "reduction identity is the program's dtype-derived identity and "
    "is a fixed point of relax/combine",
    # layer 2: AST lint (source level)
    "AL01": "no uncounted host read (.item/.tolist/.cpu/.numpy, bool/float/int, "
    "numpy or an if/while over an array parameter) and no data-dependent-shape "
    "op inside registered hot-path functions",
    "AL02": "no unbounded long-lived dict caches (BoundedCache LRU + coerced "
    "keys required)",
    "AL03": "kernels write every output element: no source form for CUDA "
    "sources; held on the card by a launch into poisoned memory",
    "AL04": "no tobytes()-style cache keys without shape/dtype context",
    "AL05": "no unused module-level imports",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one location."""

    rule: str  # key into RULES
    where: str  # "path/to/file.py:LINE" or an audit label
    message: str  # what exactly is wrong, with the offending symbol

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule id {self.rule!r}")

    def __str__(self) -> str:
        return f"{self.where}: {self.rule} {self.message}"


def render(findings: list[Finding]) -> str:
    """One line per finding, stable order (by rule, then location)."""
    ordered = sorted(findings, key=lambda f: (f.rule, f.where, f.message))
    return "\n".join(str(f) for f in ordered)
