"""DimeNet [arXiv:2003.03123]: directional message passing over edge messages
m_ji updated from triplets (k -> j -> i) with radial Bessel + angular basis
and a bilinear (DimeNet++-style down/up projected) interaction
(``repro.models.gnn.dimenet`` counterpart).

Triplets are precomputed index lists into the edge array: triplet t couples
edge_kj[t] into edge_ji[t]; padding uses mask.  Angular basis here is the
cos(n * alpha) Chebyshev family crossed with the radial basis (n_spherical x
n_radial features) -- same tensor structure as the paper's spherical Bessel
basis with a cheaper evaluation (documented simplification).

Once a forward the edges are ordered by destination (their messages live in
that order) and the triplets, renumbered to it, by ``ji``: the padding
triplets carry ``ji = 0`` after the real ones, out of order.  Every sum --
triplets onto edges, edges onto nodes, nodes onto graphs -- is then a
kernel call over ascending ids.

On ranks (``shard``: ``message_passing.GraphShard``) each rank holds a
block of the nodes, the edges and the triplets.  The edges' messages live
on the rank's block in its local destination order; laid rank by rank,
those blocks are the edge layout every triplet is renumbered to (the ranks'
inverse permutations gathered once a forward).  A triplet's ``kj`` message
may live on another rank: each block gathers the projected messages
``m @ down`` over the ranks, and its ``ji`` sums come back as the rank's
edge block (reduce-scatter).  The edge vectors are gathered once for the
triplets' geometry, the positions once for the edges', and the readout's
per-graph partial sums are summed over the ranks.
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


class DimeNetBlock(nn.Module):
    def __init__(self, d: int, nb: int, n_sbf: int, generator):
        super().__init__()
        self.w_msg = nn.Parameter(init_dense(generator, d, d, torch.float32))
        self.down = nn.Parameter(init_dense(generator, d, nb, torch.float32))
        self.sbf_w = nn.Parameter(init_dense(generator, n_sbf, nb, torch.float32))
        self.up = nn.Parameter(init_dense(generator, nb, d, torch.float32))
        self.post = MLP((d, d, d), generator=generator)
        self.out = MLP((d, d), generator=generator)


def _angular_basis(cos_angle, r, n_spherical, n_radial, r_cut):
    """cos(n*alpha) Chebyshev x radial Bessel -> [T, n_spherical*n_radial]."""
    n = torch.arange(n_spherical, dtype=torch.float32, device=r.device)
    alpha = torch.arccos(torch.clamp(cos_angle, -1.0, 1.0))
    ang = torch.cos(n * alpha[:, None])  # [T, S]
    rad = e3.bessel_rbf(r, n_radial, r_cut)  # [T, R]
    return (ang[:, :, None] * rad[:, None, :]).reshape(r.shape[0], -1)


class DimeNet(nn.Module):
    """``DimeNet(cfg, d_out=1)``: the reference's ``init_dimenet`` tree
    (``embed_species``, ``embed_edge``, ``blocks[i].{w_msg,down,sbf_w,up,
    post,out}``, ``out_final``), drawn from ``generator``, on ``device``."""

    def __init__(self, cfg: GNNConfig, d_out: int = 1, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        d, x = cfg.d_hidden, cfg.extra
        nb = x["n_bilinear"]
        n_sbf = x["n_spherical"] * x["n_radial"]
        self.embed_species = nn.Parameter(init_dense(generator, 16, d, torch.float32))
        self.embed_edge = MLP((2 * d + x["n_radial"], d, d), generator=generator)
        self.blocks = nn.ModuleList([DimeNetBlock(d, nb, n_sbf, generator)
                                     for _ in range(cfg.n_layers)])
        self.out_final = MLP((d, d, d_out), generator=generator)
        self.to(device)

    def forward(
        self,
        species: torch.Tensor,  # [N] int (or zeros for featureless graphs)
        positions: torch.Tensor,  # [N, 3]
        edge_src,
        edge_dst,  # [E] (messages flow src -> dst), or edge_src a SortedEdges and None
        trip_kj: torch.Tensor,
        trip_ji: torch.Tensor,  # [T] indices into the caller's edges: kj feeds ji
        *,
        edge_mask=None,
        trip_mask=None,
        graph_id=None,
        n_graphs: int = 1,
        backend: str | None = None,
        shard: GraphShard | None = None,
    ) -> torch.Tensor:
        """``[n_graphs, d_out]`` graph outputs (on ``shard``, of every rank's
        nodes, for the rank's blocks of nodes, edges and triplets)."""
        x = self.cfg.extra
        n = species.shape[0]  # the rank's block on a shard
        edges = as_sorted_edges(edge_src, edge_dst, n if shard is None else shard.n, edge_mask)
        e = edges.n_edges
        dev = positions.device
        # the triplets renumbered to the sorted edges (on a shard, to the
        # ranks' sorted blocks laid end to end), then ordered by ji
        rank = torch.empty_like(edges.perm)
        rank[edges.perm] = torch.arange(e, dtype=rank.dtype, device=dev)
        e_all = e
        if shard is not None:
            every = shard.axis.all_gather(rank)  # [R, e]: each rank's own order
            offsets = torch.arange(every.shape[0], dtype=rank.dtype, device=dev)[:, None] * e
            rank = (every + offsets).reshape(-1)
            e_all = rank.shape[0]
        ji = rank.index_select(0, trip_ji.long())
        ji, t_order = torch.sort(ji, stable=True)
        kj = rank.index_select(0, trip_kj.long().index_select(0, t_order))
        t_mask = None if trip_mask is None else trip_mask.index_select(0, t_order)

        pos = positions if shard is None else shard.gather(positions)
        r_vec = pos.index_select(0, edges.dst_index) - pos.index_select(0, edges.src)
        r = torch.linalg.norm(r_vec + 1e-12, dim=-1)
        rbf = e3.bessel_rbf(r, x["n_radial"], x["r_cut"]) * e3.cutoff_envelope(
            r, x["r_cut"]
        )[:, None]
        if edges.mask is not None:
            rbf = rbf * edges.mask.to(rbf.dtype)[:, None]

        h = self.embed_species[torch.clamp(species.long(), 0, 15)]
        table = h if shard is None else shard.gather(h)
        m = self.embed_edge(torch.cat(
            [edges.gather_src(table, backend=backend), edges.gather_dst(table, backend=backend),
             rbf], dim=-1))

        # triplet geometry: angle between edge ji and edge kj at shared vertex j
        r_vec_all, r_all = r_vec, r
        if shard is not None:  # every rank's edges, in the layout's order
            r_vec_all = shard.gather(r_vec)
            r_all = torch.linalg.norm(r_vec_all + 1e-12, dim=-1)
        v_ji = r_vec_all.index_select(0, ji)
        v_kj = -r_vec_all.index_select(0, kj)  # pointing j -> k
        cos_a = torch.sum(v_ji * v_kj, -1) / torch.clamp(
            torch.linalg.norm(v_ji, dim=-1) * torch.linalg.norm(v_kj, dim=-1), min=1e-9
        )
        sbf = _angular_basis(cos_a, r_all.index_select(0, kj), x["n_spherical"], x["n_radial"],
                             x["r_cut"])
        if t_mask is not None:
            sbf = sbf * t_mask.to(sbf.dtype)[:, None]

        out = torch.zeros((n, self.cfg.d_hidden), dtype=torch.float32, device=dev)
        for blk in self.blocks:
            # directional interaction: project m_kj down, modulate by angular
            # basis through the bilinear weights, aggregate onto edge ji, up-proj
            down = m @ blk.down
            if shard is not None:
                down = shard.gather(down)
            mk = down.index_select(0, kj)  # [T, nb]
            ang = sbf @ blk.sbf_w  # [T, nb]
            agg = segment_sum(ji, mk * ang, e_all, sorted_ids=True, backend=backend)  # [E, nb]
            if shard is not None:
                agg = shard.scatter(agg)
            m = blk.post(m @ blk.w_msg + agg @ blk.up) + m
            # per-block output: edge messages -> destination nodes
            contrib = _sum(
                m if edges.mask is None else m * edges.mask.to(m.dtype)[:, None], edges, backend,
                shard,
            )
            out = out + blk.out(contrib)

        site = self.out_final(out)  # [N, d_out]
        if graph_id is None:
            graph_id = torch.zeros((n,), dtype=torch.int64, device=dev)
        per_graph = segment_sum(graph_id, site, n_graphs, backend=backend)
        return per_graph if shard is None else shard.total(per_graph)


def build_triplets(edge_src, edge_dst, max_triplets: int):
    """Host-side triplet lists: pairs (e_kj, e_ji) with dst(e_kj) == src(e_ji)
    and k != i, padded/truncated to ``max_triplets``.  numpy arrays in/out."""
    e = len(edge_src)
    by_dst: dict[int, list[int]] = {}
    for idx in range(e):
        by_dst.setdefault(int(edge_dst[idx]), []).append(idx)
    kj, ji = [], []
    for e_ji in range(e):
        j = int(edge_src[e_ji])
        for e_kj in by_dst.get(j, ()):
            if int(edge_src[e_kj]) != int(edge_dst[e_ji]):
                kj.append(e_kj)
                ji.append(e_ji)
                if len(kj) >= max_triplets:
                    break
        if len(kj) >= max_triplets:
            break
    t = len(kj)
    pad = max_triplets - t
    mask = np.concatenate([np.ones(t, bool), np.zeros(pad, bool)])
    kj = np.concatenate([np.asarray(kj, np.int32), np.zeros(pad, np.int32)])
    ji = np.concatenate([np.asarray(ji, np.int32), np.zeros(pad, np.int32)])
    return kj, ji, mask
