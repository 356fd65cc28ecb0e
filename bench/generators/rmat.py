"""Graph500's R-MAT on the device, cut to its largest component.

``2**scale`` vertices and ``round(edge_factor * 2**scale)`` draws of an
edge, each bit of both endpoints chosen by the quadrant probabilities
``a, b, c`` (``d = 1 - a - b - c``); vertex ids permuted so degree does not
follow the id; self-loops and repeats dropped, both directions kept.  The
graph is the draw's largest component, its vertices numbered ``0..n-1`` in
the order of their permuted ids; every other component (most of them
isolated vertices) is left out, and no edge is added.  ``scale`` and
``edge_factor`` are chosen so that the largest component has the source
graph's vertices and undirected edges.  Weights uniform in
``[weight_low, weight_high)``, the same in both directions.
"""

from __future__ import annotations

import torch

from bench.graphs import BenchGraph, both_directions, components, generator, undirected, uniform_weights

#: the keys that shrink a configuration to a test's size
TINY = {"scale": 10}


def generate(cfg: dict, seed: int, device) -> BenchGraph:
    scale = int(cfg["scale"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    n = 1 << scale
    m = int(round(float(cfg["edge_factor"]) * n))
    gen = generator(seed, 1, device)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    ab = a + b
    a_norm, c_norm = a / ab, c / (1.0 - ab)
    for _ in range(scale):
        draws = torch.rand((2, m), generator=gen, device=device)
        row = draws[0] > ab  # bottom half
        col = draws[1] > torch.where(row, c_norm, a_norm)  # right half
        src = (src << 1) | row
        dst = (dst << 1) | col
        del draws, row, col
    perm = torch.randperm(n, generator=gen, device=device)
    lo, hi = undirected(perm[src], perm[dst], n)
    del src, dst, perm
    labels = components(n, lo, hi)
    reps, sizes = torch.unique(labels, return_counts=True)
    inside = labels == reps[torch.argmax(sizes)]
    new_id = torch.cumsum(inside, 0) - 1
    keep = inside[lo]  # an edge lies in one component: both ends or neither
    lo, hi = new_id[lo[keep]], new_id[hi[keep]]
    w = uniform_weights(lo.shape[0], float(cfg["weight_low"]), float(cfg["weight_high"]), gen)
    return both_directions(int(inside.sum()), lo, hi, w, int(reps.shape[0]))
