"""The comparison that decides ``correct``.

Each cell has a file of limits, ``bench/limits/<workload>.json``, one number
per name compared.  A run compares the answers it kept (rows drawn from the
seed) with the plain reference computed from the benchmark's own inputs,
reduces them to those numbers, and is correct when every number lies within
its limit and no operation failed (an answer that never came).
"""

from __future__ import annotations

import math

import torch


def relative_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest relative gap of ``got`` from ``ref`` over every vertex of
    every row: ``|got - ref| / ref`` where ``ref > 0``; ``inf`` where one side
    reaches a vertex the other does not, where ``ref`` is 0 and ``got`` is
    not, or where ``got`` is not a number."""
    got = got.to(torch.float64)
    ref = ref.to(torch.float64)
    if got.shape != ref.shape or bool(torch.isnan(got).any()):
        return math.inf
    unreached = torch.isinf(ref)
    if not torch.equal(unreached, torch.isinf(got)):
        return math.inf
    zero = ref == 0
    if bool((got[zero] != 0).any()):
        return math.inf
    pos = ~unreached & ~zero
    if not bool(pos.any()):
        return 0.0
    return float(((got[pos] - ref[pos]).abs() / ref[pos]).max())


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every limited number at or
    under its limit (a missing number fails)."""
    table = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        ok = ok and value <= limit
        table[name] = {"value": value if math.isfinite(value) else "inf", "limit": limit}
    return ok, table
