"""The plain reference: weighted single-source shortest paths by
Bellman-Ford over the benchmark's own edge list, in plain PyTorch.

It reads only what the benchmark made (the ``BenchGraph`` and the sources)
and imports nothing of the program.  Every pass relaxes every edge of every
row at once, ``d[v] = min(d[v], min over edges (u, v) of d[u] + w)``, by
``scatter_reduce``, until a pass changes nothing.  ``dtype`` is the
precision of the sums: float64 for the reference itself, bfloat16 for the
control that stands for a program computed one precision below the float32
the configurations state.
"""

from __future__ import annotations

import torch

from bench.graphs import BenchGraph

#: passes between two checks for a fixpoint (each check reads the device)
CHECK_EVERY = 4


def sssp(
    g: BenchGraph,
    sources,
    *,
    dtype: torch.dtype = torch.float64,
    block: int = 8,
) -> torch.Tensor:
    """``[len(sources), n]`` shortest-path distances (``inf`` where a vertex
    is unreached), ``block`` sources at a time, in ``dtype``."""
    sources = [int(s) for s in sources]
    device = g.src.device
    w = g.weights.to(dtype)
    out = torch.empty((len(sources), g.n), dtype=dtype, device=device)
    for first in range(0, len(sources), block):
        rows = torch.tensor(sources[first:first + block], device=device)
        k = rows.shape[0]
        d = torch.full((k, g.n), float("inf"), dtype=dtype, device=device)
        d[torch.arange(k, device=device), rows] = 0
        dst = g.dst.expand(k, -1)
        while True:
            before = d
            for _ in range(CHECK_EVERY):
                cand = d.index_select(1, g.src) + w
                d = d.scatter_reduce(1, dst, cand, reduce="amin", include_self=True)
                del cand
            if torch.equal(d, before):
                break
        out[first:first + k] = d
    return out
