"""MACE [arXiv:2206.07697]: higher-order equivariant (ACE) message passing
(``repro.models.gnn.mace`` counterpart).

Structure per layer (faithful skeleton; even-parity Gaunt couplings only --
see e3.py):

  A-basis  A^{l3}_c = sum_j R_{l1 l2 l3,c}(r_ij) * (Y^{l1}(r_ij) x h_j^{l2})_{l3}
  B-basis  products of A up to correlation order 3, recoupled to each L
  message  m^L = linear(B paths)
  update   h'^L = W h^L + m^L ; readout sums invariant (l=0) site energies

Features are flat [N, C, 9] tensors indexed by the real-SH slot (l<=2).  The
A-basis sum runs as one kernel call over ``[E, 9C]`` (the message reshaped),
the readout as one over the graph ids.

On ranks (``shard``: ``message_passing.GraphShard``) ``species`` and
``positions`` are the rank's node block: the positions are gathered once a
forward (both endpoints of an edge may lie on other ranks; no gradient),
the features once a layer for the rank's edges, the A-basis comes back as
the block's, and the readout's per-graph partial sums are summed over the
ranks.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.models.common import init_dense, model_device
from repro_torch.models.gnn import e3
from repro_torch.models.gnn.message_passing import MLP, GraphShard, _sum, as_sorted_edges

#: the l of each of the 9 real-SH slots
L_OF_SLOT = (0, 1, 1, 1, 2, 2, 2, 2, 2)


def coupling_paths(g: np.ndarray, device=None):
    """Nonzero (a, b, c) coupling entries as index/value tensors."""
    a, b, c = np.nonzero(g)
    return (
        torch.as_tensor(a, dtype=torch.int64, device=device),
        torch.as_tensor(b, dtype=torch.int64, device=device),
        torch.as_tensor(c, dtype=torch.int64, device=device),
        torch.as_tensor(g[a, b, c], dtype=torch.float32, device=device),
    )


def couple(u: torch.Tensor, v: torch.Tensor, paths) -> torch.Tensor:
    """Equivariant product: u, v [..., 9] -> [..., 9] via Gaunt paths (the
    reference's ``.at[..., ic].add``: an ``index_add_`` along the last
    axis)."""
    ia, ib, ic, w = paths
    prod = u[..., ia] * v[..., ib] * w
    out_shape = torch.broadcast_shapes(u.shape[:-1], v.shape[:-1]) + (9,)
    return torch.zeros(out_shape, dtype=prod.dtype, device=prod.device).index_add(-1, ic, prod)


class MACELayer(nn.Module):
    def __init__(self, c: int, n_rbf: int, generator):
        super().__init__()
        # radial MLP: rbf -> per-channel weight per *l* (not per slot: all m
        # of one l must share a weight or equivariance breaks)
        self.radial = MLP((n_rbf, 32, 3 * c), generator=generator)
        self.w_self = nn.Parameter(init_dense(generator, c, c, torch.float32))
        # B-basis path weights: order-1, order-2, order-3 combos
        self.w_b1 = nn.Parameter(init_dense(generator, c, c, torch.float32))
        self.w_b2 = nn.Parameter(init_dense(generator, c, c, torch.float32))
        self.w_b3 = nn.Parameter(init_dense(generator, c, c, torch.float32))


class MACE(nn.Module):
    """``MACE(cfg)``: the reference's ``init_mace`` tree (``species_embed``,
    ``layers[i].{radial,w_self,w_b1,w_b2,w_b3}``, ``readout``), drawn from
    ``generator``, on ``device``."""

    def __init__(self, cfg: GNNConfig, *, generator: torch.Generator | None = None,
                 device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        c, x = cfg.d_hidden, cfg.extra
        self.species_embed = nn.Parameter(init_dense(generator, x["n_species"], c, torch.float32))
        self.layers = nn.ModuleList([MACELayer(c, x["n_rbf"], generator)
                                     for _ in range(cfg.n_layers)])
        self.readout = MLP((c, c, 1), generator=generator)
        self.to(device)

    def forward(self, species: torch.Tensor, positions: torch.Tensor, edge_src, edge_dst=None,
                *, edge_mask=None, graph_id=None, n_graphs: int = 1,
                backend: str | None = None, shard: GraphShard | None = None) -> torch.Tensor:
        """Per-graph invariant energies ``[n_graphs]`` (on ``shard``, of every
        rank's nodes, for the rank's node block and edges)."""
        x = self.cfg.extra
        n = species.shape[0]  # the rank's block on a shard
        c = self.cfg.d_hidden
        edges = as_sorted_edges(edge_src, edge_dst, n if shard is None else shard.n, edge_mask)
        paths = coupling_paths(e3.gaunt_tensor(), positions.device)

        pos = positions if shard is None else shard.gather(positions)
        r_vec = pos.index_select(0, edges.dst_index) - pos.index_select(0, edges.src)
        r = torch.linalg.norm(r_vec + 1e-12, dim=-1)
        r_hat = r_vec / torch.clamp(r, min=1e-9)[:, None]
        ylm = e3.real_sh(r_hat)  # [E, 9]
        rbf = e3.bessel_rbf(r, x["n_rbf"], x["r_cut"]) * e3.cutoff_envelope(r, x["r_cut"])[:, None]
        if edges.mask is not None:
            rbf = rbf * edges.mask.to(rbf.dtype)[:, None]

        # h [N, C, 9]: scalar slot initialized from species embedding
        h = torch.zeros((n, c, 9), dtype=torch.float32, device=positions.device)
        h[:, :, 0] = self.species_embed[species.long()]

        l_of_slot = torch.as_tensor(L_OF_SLOT, dtype=torch.int64, device=positions.device)
        for layer in self.layers:
            radial_l = layer.radial(rbf).reshape(-1, c, 3)  # [E, C, L]
            radial = radial_l[:, :, l_of_slot]  # broadcast per-l weight to slots
            # A-basis: couple edge harmonics with neighbor features, radially
            # weighted, summed over neighbors: one kernel call over [E, 9C]
            table = h if shard is None else shard.gather(h)
            msg = couple(ylm[:, None, :], edges.gather_src(table, backend=backend), paths) * radial
            a = _sum(msg, edges, backend, shard)  # [N, C, 9]
            # B-basis: correlation orders 1..3
            b1 = a
            b2 = couple(a, a, paths)
            b3 = couple(b2, a, paths)
            m = (
                torch.einsum("ncs,ck->nks", b1, layer.w_b1)
                + torch.einsum("ncs,ck->nks", b2, layer.w_b2)
                + torch.einsum("ncs,ck->nks", b3, layer.w_b3)
            )
            h = torch.einsum("ncs,ck->nks", h, layer.w_self) + m

        site = self.readout(h[:, :, 0])[:, 0]  # invariant slot only
        if graph_id is None:
            graph_id = torch.zeros((n,), dtype=torch.int64, device=positions.device)
        per_graph = segment_sum(graph_id, site, n_graphs, backend=backend)
        return per_graph if shard is None else shard.total(per_graph)
