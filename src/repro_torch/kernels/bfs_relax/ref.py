"""Plain PyTorch versions of the relax reduction (the kernel's oracle).

``relax_reference`` computes the same function as the CUDA kernel with one
``scatter_reduce_``: the CPU path of every wrapper, and the comparison
``chip_smoke.py`` holds the kernel against on the card.  Nothing on the main
path calls it when the engine runs on a CUDA device with the default
backend.
"""

from __future__ import annotations

import torch

_SCATTER_REDUCE = {"min": "amin", "sum": "sum"}


def relax_reference(
    dst: torch.Tensor,  # [E] int64 ascending destination per edge
    cand: torch.Tensor,  # [S, E] candidates, identity where inactive
    base: torch.Tensor,  # [S, n]
    reduce: str,
) -> torch.Tensor:
    """``combine(base, segment_reduce(cand, dst))``; output dtype = base's.

    A float32 ``sum`` accumulates in float64 and rounds once, as the kernel
    does: a float32 running sum over a hub's many nearly equal terms
    drifts by percents.
    """
    if reduce not in _SCATTER_REDUCE:
        raise ValueError(f"reduce must be 'min' or 'sum', got {reduce!r}")
    acc = torch.float64 if reduce == "sum" and base.dtype == torch.float32 else base.dtype
    idx = dst.to(torch.int64).expand(cand.shape[0], -1)
    out = base.to(acc, copy=True).scatter_reduce_(
        1, idx, cand.to(acc), reduce=_SCATTER_REDUCE[reduce], include_self=True,
    )
    return out.to(base.dtype)


def reference_bfs_relax(dist, frontier, src, dst, w):
    """One masked min-plus relaxation of a single ``[N]`` state over edges
    in any order (the port of ``repro.kernels.bfs_relax.ref``)."""
    src = src.to(torch.int64)
    cand = torch.where(frontier[src], dist[src] + w, float("inf"))
    return relax_reference(dst.to(torch.int64), cand[None], dist[None], "min")[0]
