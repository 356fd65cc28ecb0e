"""Synthetic graph generators matched to the paper's dataset families.

The paper evaluates on LiveJournal (power-law, low diameter), USA Road
Network (bounded degree, huge diameter), and Orkut (denser power-law).
Offline we generate analogues matched on the structural properties that
drive the elasticity results: degree distribution and diameter, which
together control how the BFS frontier sweeps across partitions.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.structs import Graph, _label_propagation_components


def rmat_graph(
    scale: int,
    edge_factor: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    connect: bool = True,
) -> Graph:
    """R-MAT power-law generator (Graph500 parameters by default).

    ``scale`` -> 2**scale vertices; ``edge_factor`` edges per vertex before
    dedup/symmetrization.  Returns the symmetrized (undirected) graph.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for _ in range(scale):
        r_bit = rng.random(m) > ab  # 1 -> bottom half (row bit set)
        c_prob = np.where(r_bit, c_norm, a_norm)
        c_bit = rng.random(m) > c_prob  # 1 -> right half (col bit set)
        src = (src << 1) | r_bit
        dst = (dst << 1) | c_bit
    # permute vertex ids so degree is not correlated with id
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    g = Graph(n, src[keep].astype(np.int32), dst[keep].astype(np.int32)).symmetrized()
    if connect:
        g = _connect_components(g, rng)
    return g


def road_grid_graph(
    width: int,
    height: int,
    *,
    drop_prob: float = 0.05,
    seed: int = 0,
) -> Graph:
    """Road-network analogue: W x H 4-neighbor lattice with random street
    closures.  Diameter ~ W + H, max degree 4 -- matches the USRN regime."""
    rng = np.random.default_rng(seed)
    n = width * height
    vid = np.arange(n, dtype=np.int64).reshape(height, width)
    right = np.stack([vid[:, :-1].ravel(), vid[:, 1:].ravel()], axis=1)
    down = np.stack([vid[:-1, :].ravel(), vid[1:, :].ravel()], axis=1)
    edges = np.concatenate([right, down], axis=0)
    keep = rng.random(edges.shape[0]) >= drop_prob
    edges = edges[keep]
    g = Graph(n, edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32)).symmetrized()
    return _connect_components(g, rng)


def erdos_renyi_graph(n: int, avg_degree: float, *, seed: int = 0) -> Graph:
    """Small ER graph for unit tests."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    g = Graph(n, src[keep].astype(np.int32), dst[keep].astype(np.int32)).symmetrized()
    return _connect_components(g, rng)


def weighted(g: Graph, *, low: float = 1.0, high: float = 4.0, seed: int = 0) -> Graph:
    """Attach deterministic symmetric uniform edge weights in ``[low, high)``.

    Weights are a pure hash of the unordered endpoint pair mixed with
    ``seed`` -- reproducible across runs and process boundaries (no RNG
    state), equal for ``(u, v)`` and ``(v, u)``, and strictly positive for
    ``low > 0`` (what the weighted ``SsspProgram`` tests rely on).  Distinct
    seeds give distinct weight planes on the same graph; ``seed=0``
    reproduces the historical unseeded plane bit-for-bit.
    """
    if low <= 0:
        raise ValueError(f"edge weights must stay positive, got low={low}")
    # weight must agree for (u,v) and (v,u): derive from unordered key
    u = np.minimum(g.src, g.dst).astype(np.uint64)
    v = np.maximum(g.src, g.dst).astype(np.uint64)
    key = u * np.uint64(g.n_vertices) + v
    with np.errstate(over="ignore"):  # wrapping arithmetic is the hash
        if seed:
            # xor + splitmix-style round: a purely additive seed would only
            # shift the whole plane by one constant mod 2^31, leaving the
            # relative edge ordering identical across seeds.  seed=0 skips
            # this and reproduces the historical unseeded plane bit-for-bit.
            key = key ^ np.uint64((int(seed) * 0x9E3779B97F4A7C15) % 2**64)
            key = key * np.uint64(0xBF58476D1CE4E5B9)
            key = key ^ (key >> np.uint64(31))
        h = (key * np.uint64(2654435761)) & np.uint64(2**31 - 1)
    w = low + (high - low) * (h.astype(np.float64) / 2**31)
    return Graph(g.n_vertices, g.src, g.dst, w.astype(np.float32))


def _connect_components(g: Graph, rng: np.random.Generator) -> Graph:
    """Add one edge per extra component to make the graph connected, so a BFS
    from any source reaches everything (matches the paper's giant-WCC use)."""
    comp = _label_propagation_components(g.n_vertices, g.src, g.dst)
    n_comp = int(comp.max()) + 1
    if n_comp == 1:
        return g
    # pick one representative per component; star-connect them all to the
    # giant component's rep (adds <=2 to the diameter, unlike a chain)
    reps = np.zeros(n_comp, dtype=np.int64)
    reps[comp[::-1]] = np.arange(g.n_vertices - 1, -1, -1)  # any member
    giant = int(np.argmax(np.bincount(comp)))
    others = np.delete(reps, giant)
    extra_src = np.full(n_comp - 1, reps[giant], dtype=np.int64)
    extra_dst = others
    src = np.concatenate([g.src, extra_src.astype(np.int32), extra_dst.astype(np.int32)])
    dst = np.concatenate([g.dst, extra_dst.astype(np.int32), extra_src.astype(np.int32)])
    w = None
    if g.weights is not None:
        pad = np.ones(2 * (n_comp - 1), dtype=np.float32)
        w = np.concatenate([g.weights, pad])
    return Graph(g.n_vertices, src, dst, w)
