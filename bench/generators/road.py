"""A road network on the device: a lattice of streets with closures, cut to
its largest component.

``width × height`` junctions, each joined by a street to its right and its
lower neighbour (a 4-neighbour lattice); each street is kept with
probability ``keep`` and closed otherwise.  The graph is the draw's largest
component; every other component is left out, and no street is added.  Its
vertices are numbered ``0..n-1`` in a permutation drawn from the seed, so
that the numbering gives the gathers no locality the source's ids would not.
``width``, ``height`` and ``keep`` are chosen so that the largest component
has the source graph's vertices and undirected edges.  Weights uniform in
``[weight_low, weight_high)``, the same in both directions.  A junction has
at most four streets, and the hop diameter is about ``width + height``:
many BSP closure iterations on small frontiers.
"""

from __future__ import annotations

import torch

from bench.graphs import BenchGraph, both_directions, components, generator, undirected, uniform_weights

#: the keys that shrink a configuration to a test's size
TINY = {"width": 24, "height": 24}


def generate(cfg: dict, seed: int, device) -> BenchGraph:
    width, height = int(cfg["width"]), int(cfg["height"])
    n = width * height
    gen = generator(seed, 1, device)
    grid = torch.arange(n, dtype=torch.int64, device=device).view(height, width)
    lo = torch.cat([grid[:, :-1].reshape(-1), grid[:-1, :].reshape(-1)])
    hi = torch.cat([grid[:, 1:].reshape(-1), grid[1:, :].reshape(-1)])
    open_streets = torch.rand(lo.shape[0], generator=gen, device=device) < float(cfg["keep"])
    lo, hi = lo[open_streets], hi[open_streets]
    labels = components(n, lo, hi)
    reps, sizes = torch.unique(labels, return_counts=True)
    inside = labels == reps[torch.argmax(sizes)]
    count = int(inside.sum())
    new_id = torch.full((n,), -1, dtype=torch.int64, device=device)
    new_id[inside] = torch.randperm(count, generator=gen, device=device)
    keep = inside[lo]  # an edge lies in one component: both ends or neither
    lo, hi = undirected(new_id[lo[keep]], new_id[hi[keep]], count)
    w = uniform_weights(lo.shape[0], float(cfg["weight_low"]), float(cfg["weight_high"]), gen)
    return both_directions(count, lo, hi, w, int(reps.shape[0]))
