"""EmbeddingBag (``repro.models.recsys.embedding`` counterpart).

Tables are one ``[n_fields, vocab, dim]`` tensor, as in the reference.  The
fixed-size bag (``embedding_bag``) gathers ``[B, F, H, D]`` rows and sums the
bag axis densely, as the reference does outside any kernel.  The ragged bag
(``embedding_bag_segment``) gathers its rows and sums them by bag through the
autograd entry ``kernels.segment_sum.segment_sum``: the hand-written CUDA
segment-sum kernel on a card, its plain version on the CPU.
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist.sharding import reduce_from_model
from repro_torch.kernels.segment_sum import segment_sum


def init_embedding_tables(
    generator: torch.Generator | None, n_fields: int, vocab: int, dim: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """``[n_fields, vocab, dim]`` normal rows scaled by ``1/sqrt(dim)``, drawn
    in float32 from ``generator`` on its device (the CPU when it is None)."""
    device = generator.device if generator is not None else None
    t = torch.randn((n_fields, vocab, dim), generator=generator, dtype=torch.float32,
                    device=device)
    return (t * (1.0 / math.sqrt(dim))).to(dtype)


def embedding_bag(
    tables: torch.Tensor,  # [F, V, D]
    ids: torch.Tensor,  # [B, F, H] (H = multi-hot bag size)
    *,
    weights: torch.Tensor | None = None,  # [B, F, H] per-sample weights
    mode: str = "sum",
    axis=None,
) -> torch.Tensor:
    """-> ``[B, F, D]``: each field's rows gathered from its own table, then
    the bag axis reduced by ``mode`` (``"sum"`` or ``"mean"``).  ``axis`` (a
    ``PartitionMesh``): the model axis that splits the tables' vocab rows,
    ``tables`` the rank's block ``[F, V/T, D]``: each rank gathers the ids
    it owns (the others read as zero rows), reduces its bags, and the
    partial bags are summed over the axis; the gradient reaches only the
    rank's own rows."""
    f, v, d = tables.shape
    ids = ids.to(torch.int64)
    hit = None
    if axis is not None and axis.world_size > 1:
        ids = ids - axis.rank * v
        hit = (ids >= 0) & (ids < v)
        ids = torch.where(hit, ids, 0)
    offsets = torch.arange(f, device=ids.device, dtype=torch.int64)[None, :, None] * v
    flat = (ids + offsets).reshape(-1)
    gathered = tables.reshape(f * v, d).index_select(0, flat).reshape(*ids.shape, d)
    if hit is not None:
        gathered = torch.where(hit[..., None], gathered, 0)
    if weights is not None:
        gathered = gathered * weights[..., None]
    if mode == "sum":
        out = gathered.sum(dim=2)
    elif mode == "mean":
        out = gathered.mean(dim=2)
    else:
        raise ValueError(mode)
    return out if hit is None else reduce_from_model(out, axis)


def embedding_bag_segment(
    table: torch.Tensor,  # [V, D] one flat table
    flat_ids: torch.Tensor,  # [NNZ]
    bag_ids: torch.Tensor,  # [NNZ] -> which output row
    n_bags: int,
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """Ragged EmbeddingBag: ``[n_bags, D]`` float32 sums of
    ``table[flat_ids]`` by ``bag_ids`` (any order; the entry sorts them
    stably); a bag with no id sums to a zero row."""
    rows = table.index_select(0, flat_ids.to(torch.int64))
    return segment_sum(bag_ids, rows, n_bags, sorted_ids=False, backend=backend)
