"""The benchmark's frozen arithmetic against hand-reckoned values: the
GTEPS edge count, the relax kernel's bytes and operations, the trace's busy
union and idle gaps, the traffic generator and the comparison."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import bench_tiny  # noqa: F401  (puts the repository on the path)
from bench import check, graphs, roofline, trace, traffic


def _triangle_and_edge() -> graphs.BenchGraph:
    # a triangle 0-1-2 and a separate edge 3-4
    lo = torch.tensor([0, 1, 0, 3])
    hi = torch.tensor([1, 2, 2, 4])
    return graphs.both_directions(5, lo, hi, torch.ones(4), 2)


def test_traversed_edges_count_each_undirected_edge_of_the_component_once():
    g = _triangle_and_edge()
    labels = graphs.components(g.n, g.src, g.dst)
    assert labels.tolist() == [0, 0, 0, 3, 3]
    assert graphs.traversed_edges(g, labels, 1) == 3
    assert graphs.traversed_edges(g, labels, 4) == 1
    assert graphs.traversed_edges(g, None, 0) == 4 == g.n_undirected


def test_undirected_drops_loops_and_repeats():
    lo, hi = graphs.undirected(torch.tensor([0, 1, 2, 2, 3]), torch.tensor([1, 0, 2, 3, 2]), 4)
    assert list(zip(lo.tolist(), hi.tolist())) == [(0, 1), (2, 3)]


@pytest.mark.parametrize("s,n,e", [(16, 4_194_304, 28_064_538), (8, 1000, 5000), (1, 1, 1)])
def test_relax_bytes_and_ops_by_hand(s, n, e):
    nbytes, ops = roofline.relax_bytes_ops(s, n, e)
    # candidates [S, E] f32, row offsets [n + 1] i32, base in and out [S, n] f32
    assert nbytes == s * e * 4 + (n + 1) * 4 + s * n * 4 * 2
    assert ops == s * e
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    least = roofline.relax_least_seconds(s, n, e, peaks)
    assert least == max(nbytes / 3.35e12, ops / 67e12)


def test_livj_relax_call_is_bound_by_bytes():
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    least = roofline.relax_least_seconds(16, 4_194_304, 28_064_538, peaks)
    # 2.35 GB at 3.35 TB/s: 1.80 GB of candidates, 0.54 GB of base and output
    assert least == pytest.approx((16 * 28_064_538 * 4 + 4_194_305 * 4 + 16 * 4_194_304 * 8) / 3.35e12)
    assert 7.01e-4 < least < 7.02e-4


def test_busy_union_and_gaps_by_hand():
    events = [
        ("k1", 0.0, 10.0, True), ("k2", 5.0, 12.0, True),   # overlap: busy 0-12
        ("k3", 20.0, 25.0, True),                           # gap 12-20
        ("k4", 40.0, 41.0, True),                           # gap 25-40
        ("aten::item", 11.0, 22.0, False),                  # open over the 12-20 gap
        ("cudaStreamSynchronize", 14.0, 19.0, False),       # innermost at its middle
    ]
    out = trace.summarize(events, window_s=50e-6)
    assert out["busy_s"] == pytest.approx(18e-6)
    assert out["device_s_by_name"]["k1"] == pytest.approx(10e-6)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(8e-6)
    assert gaps["(host python)"] == pytest.approx(15e-6)
    assert out["breakdown"]["device_ops"][0][0] == "k1"


def test_open_schedule_same_gaps_in_another_order():
    t = {"rate_qps": 3.0}
    a, sa = traffic.open_schedule(t, 20.0, 1000, seed=1, instance=9)
    b, sb = traffic.open_schedule(t, 20.0, 1000, seed=2**31 + 5, instance=9)
    assert a.shape == b.shape == (60,)
    assert np.allclose(np.sort(np.diff(a, prepend=0)), np.sort(np.diff(b, prepend=0)))
    assert not np.allclose(a, b)
    assert np.array_equal(np.sort(sa), np.sort(sb)) and not np.array_equal(sa, sb)
    assert a[-1] == pytest.approx(20.0) and b[-1] == pytest.approx(20.0)
    assert (sa < 1000).all() and (sa >= 0).all()
    again, _ = traffic.open_schedule(t, 20.0, 1000, seed=1, instance=9)
    assert np.array_equal(a, again)


def test_open_schedule_modulation_keeps_the_mean_rate():
    t = {"rate_qps": 4.0, "modulation": [[1.0, 3.0], [1.0, 1.0]]}
    due, _ = traffic.open_schedule(t, 40.0, 10, seed=3, instance=9)
    on = ((due % 2.0) < 1.0).sum()
    assert due.shape == (160,)
    assert 0.6 < on / due.shape[0] < 0.9


def test_closed_pool_same_batches_in_another_order():
    t = {"batch": 4, "pool_batches": 3}
    a = traffic.pool_batches(t, 100, seed=1, instance=9)
    b = traffic.pool_batches(t, 100, seed=2, instance=9)
    first_a = [next(a) for _ in range(3)]
    first_b = [next(b) for _ in range(3)]
    as_sets = sorted(tuple(sorted(x.tolist())) for x in first_a)
    assert as_sets == sorted(tuple(sorted(x.tolist())) for x in first_b)
    assert not all(np.array_equal(x, y) for x, y in zip(first_a, first_b))
    # the pool is ordered anew once spent
    assert sorted(tuple(sorted(next(a).tolist())) for _ in range(3)) == as_sets


def test_relative_gap_edge_cases():
    ref = torch.tensor([[0.0, 1.0, math.inf, 4.0]], dtype=torch.float64)
    assert check.relative_gap(ref.float(), ref) == 0.0
    assert check.relative_gap(torch.tensor([[0.0, 1.5, math.inf, 4.0]]), ref) == pytest.approx(0.5)
    assert check.relative_gap(torch.tensor([[0.0, 1.0, 3.0, 4.0]]), ref) == math.inf
    assert check.relative_gap(torch.tensor([[1e-9, 1.0, math.inf, 4.0]]), ref) == math.inf
    assert check.relative_gap(torch.tensor([[0.0, math.nan, math.inf, 4.0]]), ref) == math.inf


def test_verdict_holds_every_number_to_its_limit():
    ok, table = check.verdict({"failed": 0.0, "gap": 1e-7}, {"failed": 0.0, "gap": 1e-5})
    assert ok and table["gap"] == {"value": 1e-7, "limit": 1e-5}
    assert not check.verdict({"failed": 1.0, "gap": 1e-7}, {"failed": 0.0, "gap": 1e-5})[0]
    ok, table = check.verdict({"failed": 0.0}, {"failed": 0.0, "gap": 1e-5})
    assert not ok and table["gap"]["value"] == "inf"


@pytest.mark.parametrize("generator,cfg", [
    ("rmat", {"scale": 8, "edge_factor": 8, "a": 0.57, "b": 0.19, "c": 0.19,
              "weight_low": 0.0, "weight_high": 1.0}),
    ("rmat", {"scale": 10, "edge_factor": 2.62, "a": 0.57, "b": 0.19, "c": 0.19,
              "weight_low": 0.0, "weight_high": 1.0}),
])
def test_generators_are_seeded_connected_and_symmetric(generator, cfg):
    from bench import spec

    gen = spec.generator(generator)
    a, b, c = gen.generate(cfg, 7, "cpu"), gen.generate(cfg, 7, "cpu"), gen.generate(cfg, 8, "cpu")
    assert torch.equal(a.src, b.src) and torch.equal(a.weights, b.weights)
    assert not torch.equal(a.weights, c.weights[: a.weights.shape[0]]) or a.n_directed != c.n_directed
    labels = graphs.components(a.n, a.src, a.dst)
    assert bool((labels == 0).all())
    key = a.src * a.n + a.dst
    twin = a.dst * a.n + a.src
    order, twin_order = torch.argsort(key), torch.argsort(twin)
    assert torch.equal(key[order], twin[twin_order])
    assert torch.equal(a.weights[order], a.weights[twin_order])
    low, high = cfg["weight_low"], cfg["weight_high"]
    assert bool((a.weights >= low).all()) and bool((a.weights < high).all())
    # the draw's largest component alone, numbered compactly: fewer vertices
    # than drawn, and every one of them has an edge
    deg = torch.bincount(a.src, minlength=a.n)
    assert a.n < 2 ** cfg["scale"] and a.n_components > 1
    assert bool((deg > 0).all())
