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
    the sorted run lengths each, whose gradient splits a tie evenly as the
    reference's does (the kernel counts the ties);
  * the node-to-edge gathers ``h[src]`` and ``h[dst]``
    (``SortedEdges.gather_src``/``gather_dst``) take a segment sum through
    the same kernel as their gradient (``kernels.segment_sum.gather_rows``),
    not ``index_select``'s atomic ``index_add_``, so a train step gives the
    same bits on every run.

**On ranks** (``GraphShard``: the flattened axis of a mesh, R ranks) each
rank holds a contiguous block of the edges and one of the nodes, the edge
ids global.  A layer gathers the node table its edges read from every
rank's block (``GraphShard.gather``: all-gather forward, reduce-scatter
backward), computes its own edges' messages on its local ``SortedEdges``
(sorted once a forward, over the global node ids), reduces them on the
kernel into an ``[N, ...]`` partial, and sums the partials into its node
block (``GraphShard.scatter``: reduce-scatter forward, all-gather
backward).  Mean and std divide the summed sums by the summed degrees; max
and min all-reduce the partial extrema (a rank with no edge into a node
holds -inf / +inf there; the 0 fill comes after), and their backward
splits a tie by the count summed over the ranks (``GraphShard.sum_ties``).
No tensor is both replicated and partial, so every parameter's gradient
on a rank is a partial sum, and their sum over the ranks is the one-rank
gradient.

Only the summation order differs from the reference, so outputs keep its
values within float32 rounding.  Masked edges contribute nothing and degree
counts exclude them; a segment with no (unmasked) edge reduces to 0 for
every kind, as in the reference (``where(isfinite(out), out, 0)`` after max
and min).  Ids outside ``[0, n)`` are dropped, as ``jax.ops.segment_*``
drops them.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import (
    PartitionMesh,
    fsdp_gather,
    reduce_from_model,
    reduce_scatter_rows,
)
from repro_torch.kernels.segment_sum import gather_rows, segment_sum, sorted_segment_sum
from repro_torch.models.common import init_dense


@dataclasses.dataclass(frozen=True, eq=False)
class GraphShard:
    """A rank's share of a graph on the flattened axis ``axis`` (R ranks):
    node block ``[rank * n / R, (rank + 1) * n / R)`` of the graph's ``n``
    nodes, and a contiguous block of its edges (see the module docstring).
    Every rank of ``axis`` calls each method at once."""

    axis: PartitionMesh
    n: int  # the graph's nodes, all ranks'

    @property
    def rows(self) -> int:
        """The nodes in a rank's block."""
        return self.n // self.axis.world_size

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole ``[n, ...]`` tensor."""
        lo = self.axis.rank * self.rows
        return full[lo:lo + self.rows]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's block of ``t`` laid end to end (node tables, and
        DimeNet's edge tensors); the gradient reduce-scattered back
        (``fsdp_gather``'s pair, along dim 0)."""
        return fsdp_gather(t, self.axis, 0)

    def scatter(self, partial: torch.Tensor) -> torch.Tensor:
        """The rank's block of the ranks' summed ``[R * rows, ...]``
        partials; the gradient all-gathered back."""
        return reduce_scatter_rows(partial, self.axis)

    def total(self, partial: torch.Tensor) -> torch.Tensor:
        """A readout's partial sums summed over the ranks, the (replicated)
        gradient passed through."""
        return reduce_from_model(partial, self.axis)

    def sum_ties(self, ties: torch.Tensor) -> torch.Tensor:
        """An extremum's tie counts summed over the ranks (backward)."""
        return self.axis.all_reduce(ties, op="sum")


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

    @functools.cached_property
    def src_order(self) -> torch.Tensor:
        """The stable argsort of ``src``: the order ``gather_src``'s
        gradient sums in."""
        return torch.argsort(self.src, stable=True)

    def gather_src(self, table: torch.Tensor, *, backend: str | None = None) -> torch.Tensor:
        """``table[src]`` (``[E, ...]``, destination order), its gradient
        summed by source through the segment-sum kernel."""
        return gather_rows(table, self.src, order=self.src_order, backend=backend)

    def gather_dst(self, table: torch.Tensor, *, backend: str | None = None) -> torch.Tensor:
        """``table[dst_index]``, its gradient summed by the ascending
        destination through the segment-sum kernel."""
        return gather_rows(table, self.dst_index, backend=backend)


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


def _sum(x: torch.Tensor, edges: SortedEdges, backend,
         shard: GraphShard | None = None) -> torch.Tensor:
    """The per-destination sum of ``x`` on the kernel; on ``shard`` the
    rank's node block of the ranks' summed partials."""
    s = segment_sum(edges.dst, x, edges.n, sorted_ids=True, backend=backend)
    return s if shard is None else shard.scatter(s)


def degrees(edges: SortedEdges, *, backend: str | None = None,
            shard: GraphShard | None = None) -> torch.Tensor:
    """``[n]`` float32 count of unmasked in-edges: the kernel at D = 1 (on
    ``shard``, the rank's node block of the counts over every rank's
    edges)."""
    if edges.mask is None:
        w = torch.ones(edges.n_edges, dtype=torch.float32, device=edges.dst.device)
    else:
        w = edges.mask.to(torch.float32)
    return _sum(w, edges, backend, shard)


def segment_mean(
    x: torch.Tensor, edges: SortedEdges, *, deg: torch.Tensor | None = None,
    backend: str | None = None, shard: GraphShard | None = None,
) -> torch.Tensor:
    """Masked mean of ``x`` ([E, d], destination order) per destination;
    ``deg`` (``degrees(edges)``) may be passed to reuse it.  On ``shard``
    the sums and the degrees are summed over the ranks before the
    division."""
    if edges.mask is not None:
        x = x * _mask_weights(edges, x.dtype)
    s = _sum(x, edges, backend, shard)
    c = degrees(edges, backend=backend, shard=shard) if deg is None else deg
    return s / torch.clamp(c, min=1.0)[:, None]


class _Extremum(torch.autograd.Function):
    """``torch.segment_reduce`` max or min over the sorted runs; backward:
    each segment's gradient split evenly among the entries that equal its
    extremum, as ``jax.ops.segment_max``'s is (``segment_reduce``'s own
    backward does not split a tie of more than two), gathered by the
    ascending destination and with the ties counted by the segment-sum
    kernel -- no atomics.  On a ``shard`` the rank's partial extrema are
    all-reduced (every rank needs every node's extremum to find its own
    edges' hits), the rank's node block returned; backward, the blocks'
    gradients all-gathered and each tie split by its count summed over the
    ranks."""

    @staticmethod
    def forward(ctx, x, dst, counts, n_valid, kind, backend, shard=None):
        out = torch.segment_reduce(x[:n_valid], kind, lengths=counts, unsafe=True)
        if shard is not None:  # -inf / +inf where a rank has no edge
            out = shard.axis.all_reduce(out, op=kind)
        ctx.save_for_backward(x, dst, out)
        ctx.n_valid, ctx.backend, ctx.shard = n_valid, backend, shard
        return out if shard is None else shard.block(out).clone()

    @staticmethod
    def backward(ctx, grad_out):
        x, dst, out = ctx.saved_tensors
        nv, shard = ctx.n_valid, ctx.shard
        if shard is not None:
            grad_out = shard.gather(grad_out)
        ids = dst[:nv]
        hit = x[:nv] == out.index_select(0, ids)
        flat = hit.reshape(nv, -1).to(torch.float32)
        ties = sorted_segment_sum(ids, flat, out.shape[0], assume_sorted=True,
                                  backend=ctx.backend).reshape(out.shape)
        if shard is not None:
            ties = shard.sum_ties(ties)
        share = grad_out / torch.clamp(ties, min=1.0).to(grad_out.dtype)
        grad = torch.zeros_like(x)
        grad[:nv] = torch.where(hit, share.index_select(0, ids), torch.zeros((), dtype=x.dtype,
                                                                              device=x.device))
        return grad, None, None, None, None, None, None


def _extremum(x: torch.Tensor, edges: SortedEdges, kind: str, backend,
              shard: GraphShard | None = None) -> torch.Tensor:
    args = (x, edges.dst, edges.counts, edges.n_valid, "max" if kind == "max" else "min",
            backend)
    out = _Extremum.apply(*args) if shard is None else _Extremum.apply(*args, shard)
    return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype, device=out.device))


def segment_reduce(
    x: torch.Tensor, edges: SortedEdges, kind: str, *, deg: torch.Tensor | None = None,
    backend: str | None = None, shard: GraphShard | None = None,
) -> torch.Tensor:
    """``kind`` in sum / mean / max / min / std of ``x`` ([E, d], in
    ``edges``' destination order) per destination, masked as the reference
    masks: max and min fill masked edges with -inf / +inf, the others
    multiply by the mask here (and the means once more).  On ``shard``,
    ``x`` is the rank's edges' and the result the rank's node block of the
    reduction over every rank's edges (``deg``: the block's degrees)."""
    if edges.mask is not None:
        if kind in ("max", "min"):
            fill = float("-inf") if kind == "max" else float("inf")
            x = torch.where((edges.mask != 0)[:, None], x,
                            torch.full((), fill, dtype=x.dtype, device=x.device))
        else:
            x = x * _mask_weights(edges, x.dtype)
    if kind == "sum":
        return _sum(x, edges, backend, shard)
    if kind == "mean":
        return segment_mean(x, edges, deg=deg, backend=backend, shard=shard)
    if kind in ("max", "min"):
        return _extremum(x, edges, kind, backend, shard)
    if kind == "std":
        deg = degrees(edges, backend=backend, shard=shard) if deg is None else deg
        m = segment_mean(x, edges, deg=deg, backend=backend, shard=shard)
        m2 = segment_mean(x * x, edges, deg=deg, backend=backend, shard=shard)
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
