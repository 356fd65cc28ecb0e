"""The road generator (``bench/generators/road.py``) at small sizes on the
CPU: seeded, one component of a 4-neighbour lattice's streets, both
directions of every street with one weight, and the share of streets kept
near ``keep``."""

from __future__ import annotations

import pytest
import torch

import bench_tiny  # noqa: F401  (puts the repository on the path)
from bench import graphs
from bench.generators import road

CFG = {"width": 40, "height": 30, "keep": 0.69, "weight_low": 0.25, "weight_high": 2.0}


def _draw(seed: int = 7, **keys) -> graphs.BenchGraph:
    return road.generate({**CFG, **keys}, seed, "cpu")


def _streets(cfg: dict) -> int:
    return (cfg["width"] - 1) * cfg["height"] + cfg["width"] * (cfg["height"] - 1)


def test_same_seed_same_graph_another_seed_another():
    a, b, c = _draw(7), _draw(7), _draw(8)
    assert a.n == b.n and a.n_components == b.n_components
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    assert torch.equal(a.weights, b.weights)
    assert a.n != c.n or not torch.equal(a.src, c.src) or not torch.equal(a.weights, c.weights)


def test_one_component_and_every_vertex_on_an_edge():
    g = _draw()
    labels = graphs.components(g.n, g.src, g.dst)
    assert bool((labels == 0).all())
    assert bool((torch.bincount(g.src, minlength=g.n) > 0).all())
    # the largest component of a draw with closures: some junctions left out
    assert g.n < CFG["width"] * CFG["height"] and g.n_components > 1


def test_both_directions_of_every_edge_with_one_weight():
    g = _draw()
    key, twin = g.src * g.n + g.dst, g.dst * g.n + g.src
    order, twin_order = torch.argsort(key), torch.argsort(twin)
    assert torch.equal(key[order], twin[twin_order])
    assert torch.equal(g.weights[order], g.weights[twin_order])
    assert bool((g.src != g.dst).all()) and torch.unique(key).shape[0] == g.n_directed


def test_weights_in_range_and_at_most_four_streets_a_junction():
    g = _draw()
    assert g.weights.dtype == torch.float32
    assert bool((g.weights >= CFG["weight_low"]).all()) and bool((g.weights < CFG["weight_high"]).all())
    assert int(torch.bincount(g.src, minlength=g.n).max()) <= 4


@pytest.mark.parametrize("keep", [0.9, 1.0])
def test_kept_share_of_streets_is_near_keep(keep):
    # at these shares the largest component holds nearly every street kept
    cfg = {**CFG, "width": 64, "height": 64, "keep": keep}
    g = road.generate(cfg, 11, "cpu")
    share = g.n_undirected / _streets(cfg)
    assert abs(share - keep) <= 0.03 * keep, share
    if keep == 1.0:
        assert g.n == 64 * 64 and g.n_components == 1 and g.n_undirected == _streets(cfg)


def test_ids_are_permuted_away_from_the_lattice():
    g = _draw()
    gap = (g.src - g.dst).abs()
    # neighbours on the lattice, numbered in its order, would be 1 or width apart
    assert float(((gap == 1) | (gap == CFG["width"])).float().mean()) < 0.05
