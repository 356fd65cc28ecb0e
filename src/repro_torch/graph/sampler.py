"""Fanout neighbor sampler for minibatch GNN training (GraphSAGE-style);
``repro.graph.sampler`` copied as it is (numpy, the same draws for the same
seed).

Produces fixed-shape (padded) k-hop samples so the sampled subgraph batches
are jit-compatible: for a seed batch of B nodes and fanouts (f1, f2, ...),
hop h yields exactly B * f1 * ... * fh neighbor slots, padded with the seed
itself (self-loops) where a node has fewer neighbors.  The sampler emits
dense index arrays + edge lists compatible with ``segment_sum`` message
passing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structs import Graph


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One message-passing block: edges from sampled srcs into dst nodes."""

    src_nodes: np.ndarray  # [n_src] global node ids (hop h+1 frontier)
    dst_nodes: np.ndarray  # [n_dst] global node ids (hop h frontier)
    edge_src: np.ndarray  # [E] indices into src_nodes
    edge_dst: np.ndarray  # [E] indices into dst_nodes
    edge_mask: np.ndarray  # [E] bool, False for padding


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    seeds: np.ndarray  # [B]
    blocks: list[SampledBlock]  # outermost hop first (input -> seed order)
    input_nodes: np.ndarray  # nodes whose features feed the first layer


class NeighborSampler:
    def __init__(self, g: Graph, fanouts: tuple[int, ...], *, seed: int = 0):
        self.g = g
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)
        self.row_ptr, self.col, _ = g.csr

    def sample(self, seeds: np.ndarray) -> SampledBatch:
        blocks: list[SampledBlock] = []
        frontier = seeds.astype(np.int64)
        for f in self.fanouts:
            nbrs, mask = self._sample_neighbors(frontier, f)
            n_dst = frontier.shape[0]
            src_nodes = nbrs.reshape(-1)  # [n_dst * f]
            edge_src = np.arange(src_nodes.shape[0], dtype=np.int64)
            edge_dst = np.repeat(np.arange(n_dst, dtype=np.int64), f)
            blocks.append(
                SampledBlock(
                    src_nodes=src_nodes,
                    dst_nodes=frontier,
                    edge_src=edge_src,
                    edge_dst=edge_dst,
                    edge_mask=mask.reshape(-1),
                )
            )
            frontier = src_nodes
        blocks.reverse()  # input-side block first
        return SampledBatch(seeds=seeds, blocks=blocks, input_nodes=frontier)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int):
        deg = (self.row_ptr[nodes + 1] - self.row_ptr[nodes]).astype(np.int64)
        # draw fanout uniform slots per node; pad with self where deg == 0
        draws = self.rng.integers(0, np.maximum(deg, 1)[:, None], (nodes.size, fanout))
        idx = self.row_ptr[nodes][:, None] + draws
        nbrs = self.col[np.minimum(idx, self.col.size - 1)]
        mask = np.broadcast_to((deg > 0)[:, None], nbrs.shape)
        nbrs = np.where(mask, nbrs, nodes[:, None])  # self-pad
        return nbrs.astype(np.int64), mask.copy()
