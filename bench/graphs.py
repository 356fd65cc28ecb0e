"""The benchmark's own graph arithmetic: undirected edge sets, connected
components, weights and the edge count a traversal is credited with.

Everything here runs in torch on whatever device the tensors lie on (the
card in a run, the CPU in the tests) and imports nothing of the program.
A generator (``bench/generators/<name>.py``) builds its undirected edge set
with these helpers and returns a ``BenchGraph``; the harness hands the
program the same edges as host arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class BenchGraph:
    """An undirected weighted graph, stored with both directions of every
    edge: ``(src[i], dst[i])`` and its twin carry the same weight."""

    n: int
    src: torch.Tensor  # [E] int64
    dst: torch.Tensor  # [E] int64
    weights: torch.Tensor  # [E] float32
    n_components: int  # of the generator's draw, before it kept one

    @property
    def n_directed(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_undirected(self) -> int:
        return self.n_directed // 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, stream)``:
    distinct streams of one run never share draws, and any whole seed
    (past 32 bits too) maps to a 64-bit state."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & ((1 << 63) - 1))
    return gen


def undirected(u: torch.Tensor, v: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Distinct undirected edges ``(lo, hi)``, ``lo < hi``, of an edge list
    (self-loops and repeats dropped), in ascending key order."""
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    keep = lo != hi
    key = torch.unique(lo[keep] * n + hi[keep])  # sorted
    return key // n, key % n


def components(n: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``[n]`` int64 component labels of the undirected edges ``(u, v)``:
    each vertex's label is the least vertex id of its component.  Min-label
    propagation both ways plus pointer jumping, until nothing changes."""
    labels = torch.arange(n, dtype=torch.int64, device=u.device)
    while True:
        prev = labels
        labels = labels.scatter_reduce(0, v, labels[u], reduce="amin", include_self=True)
        labels = labels.scatter_reduce(0, u, labels[v], reduce="amin", include_self=True)
        labels = labels[labels]
        if torch.equal(labels, prev):
            return labels


def uniform_weights(count: int, low: float, high: float, gen: torch.Generator) -> torch.Tensor:
    """``count`` float32 weights uniform in ``[low, high)``."""
    w = torch.rand(count, generator=gen, device=gen.device, dtype=torch.float32)
    top = float(np.nextafter(np.float32(high), np.float32(low)))
    return (low + (high - low) * w).clamp_(max=top)


def both_directions(
    n: int, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor, n_components: int
) -> BenchGraph:
    """The ``BenchGraph`` holding each undirected edge ``(lo, hi, w)`` in
    both directions."""
    return BenchGraph(
        n=n,
        src=torch.cat([lo, hi]),
        dst=torch.cat([hi, lo]),
        weights=torch.cat([w, w]),
        n_components=n_components,
    )


def traversed_edges(g: BenchGraph, labels: torch.Tensor | None, source: int) -> int:
    """Graph500's count for one traversal: the undirected edges of the
    source's component, each once.  ``labels`` None means the graph is
    connected (every generator here keeps one component), so the count is
    every undirected edge."""
    if labels is None:
        return g.n_undirected
    comp = labels == labels[source]
    return int((comp[g.src] & comp[g.dst]).sum()) // 2
