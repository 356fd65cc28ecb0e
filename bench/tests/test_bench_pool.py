"""``bench/pool.py``: a closed cell's pool sized from its batches' seconds,
the pool drawn as the traffic generator draws it, and one row a batch."""

from __future__ import annotations

import numpy as np
import pytest

from bench_tiny import tiny_cell
from bench import pool, traffic


def test_window_rates_by_hand():
    # every order of two 10 s and 20 s batches passes 25 s at 30 s
    assert np.allclose(pool.window_rates([10.0, 20.0], 25.0, 50, seed=1), 2 / 30)
    # 10 s then 30 s ends at 40 s; 30 s first ends at 30 s
    rates = pool.window_rates([10.0, 30.0], 25.0, 400, seed=1)
    assert set(np.round(rates, 9)) == {round(2 / 40, 9), round(1 / 30, 9)}


def test_pool_sizes_mark_pools_that_end_in_their_last_batch():
    sizes = pool.pool_sizes([20.0, 20.0, 20.0, 20.0], 51.0, seed=3)
    assert [s["k"] for s in sizes] == [1, 2, 3, 4]
    assert [s["last_batch_only"] for s in sizes] == [False, False, True, False]
    assert sizes[2]["pool_s"] == pytest.approx(60.0)
    assert sizes[2]["spread"] == 0.0 and sizes[2]["least"] == sizes[2]["most"] == 1.0


def test_first_batches_are_the_pool_the_loop_draws():
    mix = {"batch": 4, "pool_batches": 3}
    head = pool.first_batches(mix, 1000, 9, 3)
    loop = traffic.pool_batches(mix, 1000, seed=5, instance=9)
    drawn = sorted(tuple(sorted(next(loop).tolist())) for _ in range(3))
    assert drawn == sorted(tuple(sorted(row.tolist())) for row in head)
    # a smaller pool is the head of a larger one
    assert np.array_equal(pool.first_batches(mix, 1000, 9, 5)[:3], head)


def test_batch_table_counts_each_batch_on_the_cpu():
    from bench import run

    cell = tiny_cell("livj-8p.sssp16")
    ctx, _, _ = run.build(cell, 2**31 + 5, "cpu", "torch")
    rows = list(pool.batch_table(ctx, pool.first_batches(cell.traffic, ctx.n, ctx.instance, 2)))
    assert [r["batch"] for r in rows] == [0, 1]
    for r in rows:
        assert r["converged"] and r["supersteps"] >= 1 and r["host_reads"] > 0
        assert r["closure_iterations"] >= r["longest_row_iterations"] > 0
        assert r["seconds"] > 0
