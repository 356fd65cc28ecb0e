"""Message-passing primitives: edge-indexed gather -> segment reduce -> update
(``repro.models.gnn.message_passing`` counterpart).

The reference calls ``jax.ops.segment_*`` over edges in any order.  The port
orders a graph's edges by destination once (``sort_edges``: the permuted
``src``/``dst``/``mask``, the permutation and the in-edge counts), so every
``h[edges.src]`` gather comes out in destination order and every reduction
runs over ascending ids:

  * every **sum** -- ``sum``, ``mean``, ``std``'s two means, ``degrees`` --
    goes through ``kernels.segment_sum.segment_sum``: the hand-written CUDA
    kernel on a card, its plain version on the CPU, a gather as its
    gradient;
  * ``max`` and ``min`` have no kernel: one ``torch.segment_reduce`` over
    the sorted run lengths each.

Only the summation order differs from the reference, so outputs keep its
values within float32 rounding.  Masked edges contribute nothing and degree
counts exclude them; a segment with no (unmasked) edge reduces to 0 for
every kind, as in the reference (``where(isfinite(out), out, 0)`` after max
and min).  Ids outside ``[0, n)`` are dropped, as ``jax.ops.segment_*``
drops them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.models.common import init_dense


@dataclasses.dataclass(frozen=True, eq=False)
class SortedEdges:
    """A graph's edges ordered by destination (see the module docstring).

    Sorted position ``i`` holds the caller's edge ``perm[i]``.  Destinations
    outside ``[0, n)`` are set to ``n`` and sort last, where the kernel
    drops them; ``counts`` and ``n_valid`` count only the others, and
    ``dst_index`` (the gather index of ``h[edge_dst]``) reads row ``n - 1``
    for them, whose messages are dropped.
    """

    n: int  # destination segments
    src: torch.Tensor  # [E] caller's dtype, in destination order
    dst: torch.Tensor  # [E] ascending
    mask: torch.Tensor | None  # [E] or None
    perm: torch.Tensor  # [E] int64
    counts: torch.Tensor  # [n] int64 in-edges per destination (masked ones too)
    n_valid: int  # edges whose destination lies in [0, n)
    dst_index: torch.Tensor  # [E] dst with the dropped ones at n - 1

    @property
    def n_edges(self) -> int:
        return int(self.dst.shape[0])

    def permute(self, edge_values: torch.Tensor) -> torch.Tensor:
        """Per-edge values in the caller's order -> destination order."""
        return edge_values.index_select(0, self.perm)


def sort_edges(
    edge_src: torch.Tensor, edge_dst: torch.Tensor, n: int, edge_mask: torch.Tensor | None = None
) -> SortedEdges:
    """Order ``(edge_src, edge_dst, edge_mask)`` by destination, stably."""
    n = int(n)
    dst = torch.where((edge_dst >= 0) & (edge_dst < n), edge_dst, n)
    dst, perm = torch.sort(dst, stable=True)
    n_valid = int(torch.searchsorted(dst, torch.tensor(n, dtype=dst.dtype, device=dst.device)))
    counts = torch.bincount(dst[:n_valid], minlength=n)[:n]
    return SortedEdges(
        n=n,
        src=edge_src.index_select(0, perm),
        dst=dst,
        mask=None if edge_mask is None else edge_mask.index_select(0, perm),
        perm=perm,
        counts=counts,
        n_valid=n_valid,
        dst_index=dst if n_valid == dst.shape[0] else torch.clamp(dst, max=max(n - 1, 0)),
    )


def as_sorted_edges(edge_src, edge_dst, n: int, edge_mask=None) -> SortedEdges:
    """``edge_src`` itself when it is a ``SortedEdges`` (then ``edge_dst``
    and ``edge_mask`` must be None), else ``sort_edges`` of the three."""
    if isinstance(edge_src, SortedEdges):
        if edge_dst is not None or edge_mask is not None:
            raise ValueError("pass either SortedEdges or edge_src/edge_dst/edge_mask")
        if edge_src.n != n:
            raise ValueError(f"SortedEdges over {edge_src.n} nodes used with {n}")
        return edge_src
    return sort_edges(edge_src, edge_dst, n, edge_mask)


def _mask_weights(edges: SortedEdges, dtype) -> torch.Tensor:
    return edges.mask.to(dtype)[:, None]


def _sum(x: torch.Tensor, edges: SortedEdges, backend) -> torch.Tensor:
    return segment_sum(edges.dst, x, edges.n, sorted_ids=True, backend=backend)


def degrees(edges: SortedEdges, *, backend: str | None = None) -> torch.Tensor:
    """``[n]`` float32 count of unmasked in-edges: the kernel at D = 1."""
    if edges.mask is None:
        w = torch.ones(edges.n_edges, dtype=torch.float32, device=edges.dst.device)
    else:
        w = edges.mask.to(torch.float32)
    return _sum(w, edges, backend)


def segment_mean(
    x: torch.Tensor, edges: SortedEdges, *, deg: torch.Tensor | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """Masked mean of ``x`` ([E, d], destination order) per destination;
    ``deg`` (``degrees(edges)``) may be passed to reuse it."""
    if edges.mask is not None:
        x = x * _mask_weights(edges, x.dtype)
    s = _sum(x, edges, backend)
    c = degrees(edges, backend=backend) if deg is None else deg
    return s / torch.clamp(c, min=1.0)[:, None]


def _extremum(x: torch.Tensor, edges: SortedEdges, kind: str) -> torch.Tensor:
    out = torch.segment_reduce(
        x[: edges.n_valid], "max" if kind == "max" else "min", lengths=edges.counts,
        unsafe=True,
    )
    return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype, device=out.device))


def segment_reduce(
    x: torch.Tensor, edges: SortedEdges, kind: str, *, deg: torch.Tensor | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """``kind`` in sum / mean / max / min / std of ``x`` ([E, d], in
    ``edges``' destination order) per destination, masked as the reference
    masks: max and min fill masked edges with -inf / +inf, the others
    multiply by the mask here (and the means once more)."""
    if edges.mask is not None:
        if kind in ("max", "min"):
            fill = float("-inf") if kind == "max" else float("inf")
            x = torch.where((edges.mask != 0)[:, None], x,
                            torch.full((), fill, dtype=x.dtype, device=x.device))
        else:
            x = x * _mask_weights(edges, x.dtype)
    if kind == "sum":
        return _sum(x, edges, backend)
    if kind == "mean":
        return segment_mean(x, edges, deg=deg, backend=backend)
    if kind in ("max", "min"):
        return _extremum(x, edges, kind)
    if kind == "std":
        deg = degrees(edges, backend=backend) if deg is None else deg
        m = segment_mean(x, edges, deg=deg, backend=backend)
        m2 = segment_mean(x * x, edges, deg=deg, backend=backend)
        return torch.sqrt(torch.clamp(m2 - m * m, min=0.0) + 1e-6)
    raise ValueError(kind)


# -- tiny MLP ----------------------------------------------------------------


class MLP(nn.Module):
    """``x @ w[i] + b[i]``, SiLU between layers; weights ``[d_in, d_out]``
    as the reference's ``init_mlp`` tree (``w`` and ``b`` lists)."""

    def __init__(self, dims: tuple[int, ...], *, generator: torch.Generator | None = None,
                 dtype=torch.float32):
        super().__init__()
        self.w = nn.ParameterList(
            [nn.Parameter(init_dense(generator, a, b, dtype)) for a, b in zip(dims[:-1], dims[1:])]
        )
        self.b = nn.ParameterList([nn.Parameter(torch.zeros(b, dtype=dtype)) for b in dims[1:]])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1:
                x = F.silu(x)
        return x


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + eps)
