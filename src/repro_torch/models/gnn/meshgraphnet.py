"""MeshGraphNet [arXiv:2010.03409]: encode-process-decode with edge + node
MLPs, sum aggregation, residual updates, 15 processor layers
(``repro.models.gnn.meshgraphnet`` counterpart).

The edge state lives in destination order (``message_passing.sort_edges``):
the edge features are permuted once a forward, and the node outputs come
back in the caller's node order.

On ranks (``shard``: ``message_passing.GraphShard``) the edge state stays
on the rank's block of edges through every layer; each layer gathers the
node table once for both ``h[src]`` and ``h[dst]``, and its aggregate
comes back as the rank's node block, where the node MLP runs.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.models.common import model_device
from repro_torch.models.gnn.message_passing import (
    MLP,
    GraphShard,
    as_sorted_edges,
    layer_norm,
    segment_reduce,
)


class MGNLayer(nn.Module):
    def __init__(self, d: int, generator):
        super().__init__()
        self.edge = MLP((3 * d, d, d), generator=generator)
        self.node = MLP((2 * d, d, d), generator=generator)


class MeshGraphNet(nn.Module):
    """``MeshGraphNet(cfg, d_node_in, d_edge_in, d_out)``: the reference's
    ``init_mgn`` tree (``node_enc``, ``edge_enc``, ``layers[i].{edge,node}``,
    ``decode``), drawn from ``generator``, on ``device``."""

    def __init__(self, cfg: GNNConfig, d_node_in: int, d_edge_in: int, d_out: int, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        d = cfg.d_hidden
        self.node_enc = MLP((d_node_in, d, d), generator=generator)
        self.edge_enc = MLP((d_edge_in, d, d), generator=generator)
        self.layers = nn.ModuleList([MGNLayer(d, generator) for _ in range(cfg.n_layers)])
        self.decode = MLP((d, d, d_out), generator=generator)
        self.to(device)

    def forward(self, x: torch.Tensor, e_feat: torch.Tensor, edge_src, edge_dst=None, *,
                edge_mask=None, backend: str | None = None,
                shard: GraphShard | None = None) -> torch.Tensor:
        """``[N, d_out]`` for node features ``x`` and per-edge features
        ``e_feat`` (in the caller's edge order); on ``shard``, the rank's
        node block's for its block of ``x`` and its edges."""
        n = x.shape[0] if shard is None else shard.n
        edges = as_sorted_edges(edge_src, edge_dst, n, edge_mask)
        h = layer_norm(self.node_enc(x))
        e = layer_norm(self.edge_enc(edges.permute(e_feat)))
        for layer in self.layers:
            table = h if shard is None else shard.gather(h)
            e = e + layer.edge(torch.cat(
                [e, edges.gather_src(table, backend=backend),
                 edges.gather_dst(table, backend=backend)], dim=-1))
            agg = segment_reduce(e, edges, "sum", backend=backend, shard=shard)
            h = h + layer.node(torch.cat([h, agg], dim=-1))
        return self.decode(h)
