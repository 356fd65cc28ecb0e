"""Weighted single-source shortest paths (Graph500's third kernel).

The system runs the port's ``SsspProgram``; the reference is
``bench.reference.sssp`` over the benchmark's own edges; the number compared
is ``dist_rel_gap``, the widest relative gap of a returned float32
distance from the float64 reference (``bench.check.relative_gap``).  The
control recomputes the answers in bfloat16, the precision below the
configurations' float32.
"""

from __future__ import annotations

import torch

from bench import check, reference

NUMBER = "dist_rel_gap"
CONTROL_DTYPE = torch.bfloat16


def port_program():
    from repro_torch.graph.program import SsspProgram

    return SsspProgram()


def reference_rows(g, sources, dtype=torch.float64) -> torch.Tensor:
    return reference.sssp(g, sources, dtype=dtype)


def compare(got: torch.Tensor, ref: torch.Tensor) -> float:
    return check.relative_gap(got, ref)
