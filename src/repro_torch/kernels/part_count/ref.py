"""Plain PyTorch version of the partition counters (the kernel's oracle).

``part_counts_reference`` adds each weighted frontier row into one int64
bin per partition with ``scatter_add_``, every id outside ``[0, P)`` sent
to a last bin that is dropped, and narrows the exact sums to int32.  It is
the CPU path of ``ops.part_counts`` and the comparison ``chip_smoke.py``
holds the kernel against on the card.
"""

from __future__ import annotations

import torch


def part_counts_reference(
    x: torch.Tensor,  # [R, n] bool
    weights: tuple,  # W of [n] integer, or None for ones
    part_of: torch.Tensor,  # [n] integer, outside [0, P) counts nowhere
    n_parts: int,
) -> torch.Tensor:
    """``[W * R, P]`` int32: ``out[w * R + r, p]`` sums ``x[r, v] *
    weights[w][v]`` over the vertices ``v`` of part ``p``."""
    r, n = x.shape
    part = part_of.to(torch.int64)
    group = torch.where((part >= 0) & (part < n_parts), part, n_parts).expand(r, n)
    sums = [
        torch.zeros((r, n_parts + 1), dtype=torch.int64, device=x.device).scatter_add_(
            1, group, x.to(torch.int64) if w is None else x * w.to(torch.int64)
        )
        for w in weights
    ]
    return torch.cat(sums)[:, :n_parts].to(torch.int32)
