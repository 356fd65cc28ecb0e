"""The partition counters' entry point and its backend switch.

``part_counts`` turns an ``[R, n]`` bool frontier into ``[W * R, P]`` int32
per-partition sums, one ``[R, P]`` block for each of the ``W`` weightings in
order: the BSP window loop's work counters (frontier vertices, the local
and remote edges they examine) and its partition activity.  It routes by
``backend`` through ``kernels.build.validate_backend``, as every entry does:

  * ``"cuda"`` -- the hand-written Hopper kernel (``kernel.part_count``),
    the default on a CUDA device.  It raises on CPU tensors.
  * ``"torch"`` -- the plain version (``ref.part_counts_reference``), the
    only backend on the CPU.

Both give the same integers: the exact sums narrowed to int32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import validate_backend
from repro_torch.kernels.part_count.kernel import part_count
from repro_torch.kernels.part_count.ref import part_counts_reference


def part_counts(
    x: torch.Tensor,  # [R, n] bool
    weights: tuple,  # W of [n] integer per-vertex weights, None for ones
    part_of: torch.Tensor,  # [n] integer partition id; outside [0, P) counts nowhere
    n_parts: int,
    backend: str | None = None,
) -> torch.Tensor:
    """``[W * R, P]`` int32: row ``w * R + r`` holds, for each partition
    ``p``, the sum of ``weights[w][v]`` (1 for ``None``) over the vertices
    ``v`` of ``p`` with ``x[r, v]`` set.

    The kernel sums modulo 2**32, which is the exact sum narrowed to int32,
    so weights are taken as int32 (a wider weight's narrowing gives the same
    sums).
    """
    backend = validate_backend(backend, x.device)
    weights = tuple(weights)
    if x.dtype != torch.bool or x.dim() != 2:
        raise TypeError(f"part_counts: x must be a 2-D bool tensor, got {x.dtype} {tuple(x.shape)}")
    n = x.shape[1]
    if not weights:
        raise ValueError("part_counts: no weighting given")
    for t in (part_of, *(w for w in weights if w is not None)):
        if t.shape != (n,) or t.is_floating_point() or t.dtype == torch.bool:
            raise TypeError(
                f"part_counts: part ids and weights must be [{n}] integer tensors, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if backend == "torch":
        return part_counts_reference(x, weights, part_of, n_parts)
    if x.shape[0] == 0 or n == 0:
        return torch.zeros((len(weights) * x.shape[0], n_parts), dtype=torch.int32, device=x.device)
    return part_count(
        x.contiguous(),
        tuple(None if w is None else w.to(torch.int32).contiguous() for w in weights),
        part_of.to(torch.int32).contiguous(),
        n_parts,
    )
