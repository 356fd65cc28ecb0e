"""The sorted segment sum's entry point and its backend switch.

``sorted_segment_sum`` is the counterpart of
``repro.kernels.segment_sum.ops.sorted_segment_sum``.  It routes by
``backend`` through ``kernels.build.validate_backend``, as every entry does:

  * ``"cuda"`` -- the hand-written Hopper kernel
    (``kernel.segment_sum_sorted``), the default on a CUDA device.  It
    raises on CPU tensors.
  * ``"torch"`` -- the plain version (``ref.reference_segment_sum``), the
    only backend on the CPU.

The TPU wrapper's block sizes, its pads of E and N to whole blocks and of
D to the 128-wide lane are gone: the kernel takes any E, N and D.

``segment_sum`` is the differentiable entry the GNN models call: its
forward is ``sorted_segment_sum`` on either backend, its backward the
gather ``grad_out[ids]`` (0 for a dropped id).  The JAX package has no
backward kernel for the sum, so neither has the port.

``gather_rows`` is its mirror image, the row gather ``table[index]`` whose
gradient is a segment sum by ``index``: the kernel on a card, over the
index sorted once (``order``).  ``index_select``'s own backward is
``index_add_``, which adds by atomics on a card in an order that changes
from run to run; through the kernel, a training step gives the same bits
every time it runs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import validate_backend
from repro_torch.kernels.segment_sum.kernel import segment_sum_sorted
from repro_torch.kernels.segment_sum.ref import reference_segment_sum


def sorted_segment_sum(
    ids: torch.Tensor,  # [E] int32 | int64
    vals: torch.Tensor,  # [E, D] float32 | bfloat16
    n_segments: int,
    *,
    assume_sorted: bool = False,  # ids already ascending (else sorted here)
    backend: str | None = None,
) -> torch.Tensor:
    """``[n_segments, D]`` float32 sums of ``vals`` rows by segment id; ids
    outside ``[0, n_segments)`` are dropped.

    The kernel needs ascending ids: unless ``assume_sorted``, a stable
    argsort orders ids and rows first, as the JAX wrapper does.  The plain
    version takes any order and skips the sort.
    """
    backend = validate_backend(backend, vals.device)
    if ids.dim() != 1 or vals.dim() != 2 or ids.shape[0] != vals.shape[0]:
        raise ValueError(
            f"sorted_segment_sum: ids {tuple(ids.shape)} and vals "
            f"{tuple(vals.shape)} must be [E] and [E, D]"
        )
    if backend == "torch":
        return reference_segment_sum(ids, vals, n_segments)
    if not assume_sorted:
        order = torch.argsort(ids, stable=True)
        ids, vals = ids[order], vals[order]
    return segment_sum_sorted(ids.contiguous(), vals.contiguous(), n_segments)


class _SegmentSum(torch.autograd.Function):
    """``sorted_segment_sum`` forward; ``grad_out[ids]`` backward."""

    @staticmethod
    def forward(ctx, ids, vals, n_segments, assume_sorted, backend):
        ctx.save_for_backward(ids)
        ctx.n_segments = n_segments
        ctx.vals_dtype = vals.dtype
        return sorted_segment_sum(
            ids, vals, n_segments, assume_sorted=assume_sorted, backend=backend
        )

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        n = ctx.n_segments
        # a dropped id reads the zero row appended at n
        spare = torch.where((ids >= 0) & (ids < n), ids, n)
        padded = torch.cat([grad_out, grad_out.new_zeros((1, grad_out.shape[1]))])
        grad = padded.index_select(0, spare).to(ctx.vals_dtype)
        return None, grad, None, None, None


def segment_sum(
    ids: torch.Tensor,  # [E] int32 | int64
    vals: torch.Tensor,  # [E, ...] float32 | bfloat16
    n_segments: int,
    *,
    sorted_ids: bool = False,  # ids already ascending
    backend: str | None = None,
) -> torch.Tensor:
    """``[n_segments, ...]`` float32 sums of ``vals`` by segment id, through
    the kernel on a card (``backend`` as ``sorted_segment_sum``), with a
    gather as its gradient.  ``vals``' trailing dims are flattened into the
    kernel's D and restored; ids outside ``[0, n_segments)`` are dropped."""
    if ids.dim() != 1 or vals.dim() < 1 or ids.shape[0] != vals.shape[0]:
        raise ValueError(
            f"segment_sum: ids {tuple(ids.shape)} and vals {tuple(vals.shape)} "
            "must be [E] and [E, ...]"
        )
    tail = vals.shape[1:]
    flat = vals.reshape(vals.shape[0], math.prod(tail))
    out = _SegmentSum.apply(ids, flat, int(n_segments), bool(sorted_ids), backend)
    return out.reshape((int(n_segments), *tail))


class _GatherRows(torch.autograd.Function):
    """``table[index]`` forward; ``sorted_segment_sum`` backward."""

    @staticmethod
    def forward(ctx, table, index, order, backend):
        ctx.save_for_backward(index, order)
        ctx.n_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        ctx.backend = backend
        return table.index_select(0, index)

    @staticmethod
    def backward(ctx, grad_out):
        index, order = ctx.saved_tensors
        if order is not None:
            index, grad_out = index[order], grad_out.index_select(0, order)
        tail = grad_out.shape[1:]
        flat = grad_out.reshape(grad_out.shape[0], math.prod(tail))
        grad = sorted_segment_sum(index, flat, ctx.n_rows, assume_sorted=True,
                                  backend=ctx.backend)
        return grad.reshape((ctx.n_rows, *tail)).to(ctx.table_dtype), None, None, None


def gather_rows(
    table: torch.Tensor,  # [N, ...]
    index: torch.Tensor,  # [E] int, in [0, N)
    *,
    order: torch.Tensor | None = None,  # stable argsort of index; None: index ascends
    backend: str | None = None,
) -> torch.Tensor:
    """``table.index_select(0, index)``, with the segment sum of the
    gradient's rows by ``index`` (``backend`` as ``sorted_segment_sum``) as
    its gradient: ``index`` must ascend, or ``order`` sort it."""
    if index.dim() != 1 or table.dim() < 1:
        raise ValueError(
            f"gather_rows: table {tuple(table.shape)} and index {tuple(index.shape)} "
            "must be [N, ...] and [E]"
        )
    return _GatherRows.apply(table, index, order, backend)
