"""Halo-exchange plans for partitioned graphs (``repro.dist.halo``
counterpart).

A ``HaloPlan`` freezes, per shard pair (p, q), the local rows shard p must
send to shard q so that every cross-partition edge can be evaluated on the
shard owning its *destination*.  Per layer the exchange is then a single
all-to-all of ``P * s_max`` rows per shard (the planned edge cut) -- compare
a full-table all-gather of ``N`` rows.  Plans are built from the same
partitioner output the elastic placement layer uses, so partition quality
directly becomes wire-byte savings.

Layout contract (consumed by ``models.gnn.halo_pna``):
  * shard p owns rows ``[p*n_local, (p+1)*n_local)`` of the padded global
    table; ``perm[v]`` is vertex v's padded row.
  * extended local index space on a shard: ``[0, n_local)`` own rows, then
    ``n_local + p*s_max + i`` = slot i received from shard p.
  * ``send_idx[p, q, i] == n_local`` marks an unused (padding) send slot.

``build_halo_plan`` gives the reference's arrays byte for byte; where the
reference walks every edge in Python, it sorts and counts with numpy.
``halo_gather`` runs inside one rank of a ``PartitionMesh``: one
``all_to_all`` of ``[P, s_max, d]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.dist.sharding import PartitionMesh
from repro_torch.graph.structs import PartitionedGraph, sorted_distinct


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    n_shards: int
    n_local: int  # padded vertices per shard
    s_max: int  # padded send slots per shard pair
    perm: np.ndarray  # [n] vertex -> row in the padded [P*n_local] table
    send_idx: np.ndarray  # [P, P, s_max] local rows p sends to q (pad=n_local)
    edge_src_ext: np.ndarray  # [P, e_max] extended-local src per edge
    edge_dst_loc: np.ndarray  # [P, e_max] local dst per edge
    edge_mask: np.ndarray  # [P, e_max] True for real edges


def _rank_in_groups(groups: np.ndarray, n_groups: int) -> np.ndarray:
    """Each element's position among the elements of its group, in their
    own order (the reference's running fill counters)."""
    order = np.argsort(groups, kind="stable")
    starts = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(np.bincount(groups, minlength=n_groups), out=starts[1:])
    rank = np.empty(groups.size, dtype=np.int64)
    rank[order] = np.arange(groups.size, dtype=np.int64) - starts[groups[order]]
    return rank


def build_halo_plan(pg: PartitionedGraph) -> HaloPlan:
    """Plan the boundary exchange for ``pg`` (edges live on their dst shard)."""
    g = pg.graph
    part = pg.part_of_vertex.astype(np.int64)
    n, p_count = g.n_vertices, pg.n_parts

    # local (within-shard) vertex numbering
    counts = np.bincount(part, minlength=p_count)
    n_local = max(1, int(counts.max()))
    loc = _rank_in_groups(part, p_count)
    perm = part * n_local + loc

    src = g.src.astype(np.int64)
    src_p, dst_p = part[g.src], part[g.dst]

    # send lists per ordered shard pair (p -> q): the distinct sources of
    # its remote edges, ascending by vertex id
    remote = src_p != dst_p
    pair = src_p * p_count + dst_p
    keys = sorted_distinct(pair[remote] * n + src[remote])  # sorted by (pair, u)
    key_pair, key_u = keys // n, keys % n
    pair_start = np.searchsorted(key_pair, np.arange(p_count * p_count + 1))
    slot = np.arange(keys.size, dtype=np.int64) - pair_start[key_pair]
    s_max = max(1, int(np.diff(pair_start).max(initial=0)))

    send_idx = np.full((p_count, p_count, s_max), n_local, dtype=np.int32)
    send_idx.reshape(p_count * p_count, s_max)[key_pair, slot] = loc[key_u]

    # per-shard edge tables in extended-local coordinates
    e_max = max(1, int(np.bincount(dst_p, minlength=p_count).max()))
    ext = loc[src]
    edge_slot = slot[np.searchsorted(keys, pair[remote] * n + src[remote])]
    ext[remote] = n_local + src_p[remote] * s_max + edge_slot
    fill = _rank_in_groups(dst_p, p_count)
    edge_src_ext = np.zeros((p_count, e_max), dtype=np.int32)
    edge_dst_loc = np.zeros((p_count, e_max), dtype=np.int32)
    edge_mask = np.zeros((p_count, e_max), dtype=bool)
    edge_src_ext[dst_p, fill] = ext
    edge_dst_loc[dst_p, fill] = loc[g.dst]
    edge_mask[dst_p, fill] = True

    return HaloPlan(
        n_shards=p_count,
        n_local=n_local,
        s_max=s_max,
        perm=perm,
        send_idx=send_idx,
        edge_src_ext=edge_src_ext,
        edge_dst_loc=edge_dst_loc,
        edge_mask=edge_mask,
    )


def scatter_nodes(plan: HaloPlan, x: np.ndarray) -> np.ndarray:
    """[n, F] global node features -> [P, n_local, F] shard-major (zero pad)."""
    x = np.asarray(x)
    out = np.zeros((plan.n_shards * plan.n_local,) + x.shape[1:], dtype=x.dtype)
    out[plan.perm] = x
    return out.reshape((plan.n_shards, plan.n_local) + x.shape[1:])


def halo_gather(h: torch.Tensor, send_idx: torch.Tensor, mesh: PartitionMesh) -> torch.Tensor:
    """Inside one rank: exchange boundary rows; returns [P*s_max, d].

    ``h`` is this shard's [n_local, d] block and ``send_idx`` its [P, s_max]
    send table.  Row block p of the result holds the rows shard p sent here,
    in slot order -- i.e. exactly the ``n_local + p*s_max + i`` extended ids
    of the plan.  Padding slots (index n_local) read a zero row.  One
    ``mesh.all_to_all`` (counted in ``mesh.stats``); a one-rank mesh keeps
    its own block.
    """
    p, s_max = send_idx.shape
    zero = h.new_zeros((1,) + tuple(h.shape[1:]))
    outgoing = torch.cat([h, zero], dim=0)[send_idx.long()]  # [P, s_max, d]
    incoming = outgoing if mesh.world_size == 1 else mesh.all_to_all(outgoing)
    return incoming.reshape((p * s_max,) + tuple(h.shape[1:]))
