"""Plain PyTorch version of the sorted segment sum (the kernel's oracle).

``reference_segment_sum`` is the port of ``repro.kernels.segment_sum.ref``
(``jax.ops.segment_sum`` in float32): the CPU path of ``sorted_segment_sum``
and the comparison ``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import torch


def reference_segment_sum(
    ids: torch.Tensor,  # [E] int, any order
    vals: torch.Tensor,  # [E, D]
    n_segments: int,
) -> torch.Tensor:
    """``out[n] = sum(vals[ids == n])`` as float32 ``[n_segments, D]``
    (float64 for float64 values, the sums a float64 oracle needs).

    Ids outside ``[0, n_segments)`` are dropped, as ``jax.ops.segment_sum``
    drops them: they are sent to one spare row that is cut off.
    """
    ids = ids.to(torch.int64)
    spare = torch.where((ids >= 0) & (ids < n_segments), ids, n_segments)
    dtype = torch.float64 if vals.dtype == torch.float64 else torch.float32
    out = torch.zeros((n_segments + 1, vals.shape[1]), dtype=dtype, device=vals.device)
    out.index_add_(0, spare, vals.to(dtype))
    return out[:n_segments]
