"""PNA over halo-exchange sharding: the paper-bridge optimization
(``repro.models.gnn.halo_pna`` counterpart).

Mathematically identical to ``PNA.forward`` (the message MLP is row-wise, so
applying it to [own | halo] rows then gathering equals gathering then
applying), but executed with one boundary all-to-all per layer instead of
full-table all-gathers/all-reduces: wire bytes ~ P * Smax * F (the planned
edge cut) instead of N * F per collective.  Plans come from
``repro_torch.dist.halo.build_halo_plan`` -- i.e. from the same BFS-grow
partitioner the paper's elastic placement layer uses.

Where the reference maps one function over the shards with ``shard_map``,
the port runs ``pna_forward_halo`` once in each rank process of a
``PartitionMesh`` (started by ``repro_torch.dist.run_ranks``), on that
rank's block of the plan; it reuses a ``PNA`` module's parameters, and its
segment sums go through the same kernel as the dense forward's.
"""

from __future__ import annotations

import torch

from repro_torch.dist.halo import HaloPlan, halo_gather
from repro_torch.dist.sharding import PartitionMesh
from repro_torch.models.gnn.message_passing import degrees, sort_edges
from repro_torch.models.gnn.pna import PNA

__all__ = ["PNA", "pna_forward_halo", "rank_inputs"]


def rank_inputs(plan: HaloPlan, xs, rank: int, device) -> dict:
    """One rank's block of the plan and of the shard-major features ``xs``
    ``[P, n_local, F]`` (from ``scatter_nodes``), as tensors on ``device``."""
    dev = torch.device(device)
    return {
        "x": torch.as_tensor(xs[rank], device=dev),
        "send_idx": torch.as_tensor(plan.send_idx[rank], device=dev),
        "edge_src_ext": torch.as_tensor(plan.edge_src_ext[rank], device=dev),
        "edge_dst_loc": torch.as_tensor(plan.edge_dst_loc[rank], device=dev),
        "edge_mask": torch.as_tensor(plan.edge_mask[rank], device=dev),
    }


def pna_forward_halo(
    model: PNA,
    mesh: PartitionMesh,
    x: torch.Tensor,  # [Nl, F] this shard's node features
    send_idx: torch.Tensor,  # [P, Smax]
    edge_src_ext: torch.Tensor,  # [Emax] into [0, Nl + P*Smax)
    edge_dst_loc: torch.Tensor,  # [Emax] into [0, Nl)
    edge_mask: torch.Tensor,  # [Emax]
    *,
    avg_log_degree: float = 2.0,
    backend: str | None = None,
) -> torch.Tensor:
    """This rank's ``[Nl, d_out]`` node outputs; every rank of ``mesh``
    calls it at once (one ``all_to_all`` a layer)."""
    nl = x.shape[0]
    edges = sort_edges(edge_src_ext, edge_dst_loc, nl, edge_mask)
    h = model.encode(x)
    deg = degrees(edges, backend=backend)
    scaler_fns = model.scalers(deg, avg_log_degree)
    for layer in model.layers:
        halo = halo_gather(h, send_idx, mesh)  # [P*Smax, d]
        h_ext = torch.cat([h, halo], dim=0)
        h = model.layer(layer, h, h_ext, edges, deg, scaler_fns, backend)
    return model.decode(h)
