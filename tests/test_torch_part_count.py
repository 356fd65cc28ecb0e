"""The partition counters' entry (``kernels.part_count.ops.part_counts``) on
the CPU: its plain version against a numpy reference (``np.add.at`` over the
part ids) at R in {1, 3, 16, 32}, an n that is not a multiple of 16, P in
{1, 8, 40}, W in {1, 2, 3} with ``None`` weightings, and part ids outside
[0, P) that count nowhere; the kernel's launch grid (a zero-row launch is
refused by ``check_grid``); the wrapper's refusals; and an engine on the
``torch`` backend, which launches the kernel no time.  The card tests hold
the kernel to the same plain version bit for bit
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.graph.config import EngineConfig
from repro_torch.graph.generators import rmat_graph, weighted
from repro_torch.graph.partition import bfs_grow_partition
from repro_torch.graph.program import BUILTIN_PROGRAMS
from repro_torch.graph.traversal import TraversalEngine
from repro_torch.kernels.build import check_grid
from repro_torch.kernels.part_count import part_count, part_counts
from repro_torch.kernels.part_count.kernel import COUNTER_WORDS, group_rows, launch_grid


def _numpy_counts(x, weights, part_of, n_parts):
    """``[W * R, P]`` int32 by ``np.add.at`` in int64, ids outside [0, P)
    dropped."""
    r = x.shape[0]
    out = np.zeros((len(weights) * r, n_parts), dtype=np.int64)
    keep = (part_of >= 0) & (part_of < n_parts)
    for w, wt in enumerate(weights):
        vals = x.astype(np.int64) * (1 if wt is None else wt.astype(np.int64))
        for row in range(r):
            np.add.at(out[w * r + row], part_of[keep], vals[row, keep])
    return out.astype(np.int32)


def _case(seed, r, n, p, n_weights, none_at, density, outside=0.0):
    rng = np.random.default_rng(seed)
    x = rng.random((r, n)) < density
    part_of = rng.integers(0, p, n).astype(np.int32)
    drop = rng.random(n) < outside
    part_of[drop] = rng.choice([-1, -7, p, p + 3], drop.sum())
    weights = [
        None if w in none_at else rng.integers(0, 5000, n).astype(np.int32)
        for w in range(n_weights)
    ]
    return x, weights, part_of


@pytest.mark.parametrize("r", [1, 3, 16, 32])
@pytest.mark.parametrize("p", [1, 8, 40])
@pytest.mark.parametrize(
    "n_weights,none_at", [(1, ()), (1, (0,)), (2, (1,)), (3, (2,)), (3, (0, 2))],
    ids=["w1", "w1-none", "w2-none", "w3-none", "w3-two-none"],
)
def test_plain_counts_match_numpy(r, p, n_weights, none_at):
    n = 16 * 37 + 11  # not a multiple of 16
    x, weights, part_of = _case(r * 1000 + p * 10 + n_weights, r, n, p, n_weights, none_at, 0.3)
    got = part_counts(
        torch.from_numpy(x), tuple(None if w is None else torch.from_numpy(w) for w in weights),
        torch.from_numpy(part_of), p,
    )
    assert got.dtype == torch.int32 and got.shape == (n_weights * r, p)
    np.testing.assert_array_equal(got.numpy(), _numpy_counts(x, weights, part_of, p))


@pytest.mark.parametrize("density", [0.0, 1.0, 0.02])
def test_plain_counts_drop_ids_outside_the_parts(density):
    x, weights, part_of = _case(5, 16, 1000, 8, 2, (1,), density, outside=0.25)
    got = part_counts(
        torch.from_numpy(x), (torch.from_numpy(weights[0]), None), torch.from_numpy(part_of), 8
    )
    np.testing.assert_array_equal(got.numpy(), _numpy_counts(x, weights, part_of, 8))


def test_plain_counts_narrow_like_the_kernel():
    """Sums past 2**31 wrap as an int64 sum narrowed to int32 (the kernel's
    uint32 adds), and an int64 weight gives what its int32 narrowing gives."""
    n = 600
    x = torch.ones((2, n), dtype=torch.bool)
    big = torch.full((n,), 2**22 + 3, dtype=torch.int64)
    part_of = torch.zeros(n, dtype=torch.int32)
    got = part_counts(x, (big,), part_of, 1)
    want = np.int64(n * (2**22 + 3)).astype(np.int32)
    assert got.tolist() == [[int(want)], [int(want)]]
    np.testing.assert_array_equal(got, part_counts(x, (big.to(torch.int32),), part_of, 1))


def test_plain_counts_of_empty_shapes():
    part_of = torch.zeros(7, dtype=torch.int32)
    assert part_counts(torch.zeros((0, 7), dtype=torch.bool), (None, None), part_of, 3).shape == (0, 3)
    empty = part_counts(torch.zeros((2, 0), dtype=torch.bool), (None,), part_of[:0], 3)
    assert empty.tolist() == [[0, 0, 0], [0, 0, 0]]


def test_entry_refuses_what_it_does_not_take():
    x = torch.zeros((2, 5), dtype=torch.bool)
    part_of = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        part_counts(x.to(torch.int32), (None,), part_of, 2)
    with pytest.raises(TypeError):
        part_counts(x, (torch.zeros(4, dtype=torch.int32),), part_of, 2)
    with pytest.raises(TypeError):
        part_counts(x, (torch.zeros(5),), part_of, 2)
    with pytest.raises(ValueError):
        part_counts(x, (), part_of, 2)
    with pytest.raises(ValueError):
        part_counts(x, (None,), part_of, 2, backend="cuda")  # a CPU tensor
    with pytest.raises(ValueError):
        part_count(x, (None,), part_of, 2)  # the kernel takes CUDA tensors only


@pytest.mark.parametrize(
    "rows,n,w,p,grid,rows_a_group",
    [
        (16, 5_062_474, 2, 8, (1236, 1), 16),
        (32, 5_062_474, 3, 40, (1236, 1), 32),
        (1, 1, 1, 1, (1, 1), 1),
        (300, 4097, 3, 40, (2, 5), 68),
        (0, 100, 1, 8, (1, 0), 0),
        (4, 0, 1, 8, (0, 1), 4),
    ],
)
def test_launch_grid(rows, n, w, p, grid, rows_a_group):
    assert launch_grid(rows, n, w, p) == grid
    assert group_rows(rows, w, p) == rows_a_group
    assert rows_a_group * w * p <= COUNTER_WORDS
    if rows and n:
        check_grid(grid, "part_count")
    else:  # a zero-row (or zero-vertex) launch never reaches the card
        with pytest.raises(ValueError, match="zero dimension"):
            check_grid(grid, "part_count")


@pytest.mark.parametrize("name", sorted(BUILTIN_PROGRAMS))
def test_engine_on_the_torch_backend_launches_no_kernel(name):
    pg = bfs_grow_partition(weighted(rmat_graph(8, 8, seed=3), seed=2), 5, seed=1)
    before = part_count.launches
    eng = TraversalEngine(
        pg, program=BUILTIN_PROGRAMS[name](), config=EngineConfig(device="cpu", m_max=64)
    )
    res = eng.run([0, 37, 200])
    assert eng.backend == "torch" and eng.scan_elems > 0
    assert eng.part_count_launches == 0 and part_count.launches == before
    assert np.asarray(res.verts_processed).sum() > 0


def test_window_audit_flags_a_counters_launch_without_check_grid(monkeypatch):
    """The window auditor holds the counters' kernel to one grid check a
    launch, apart from the relax kernel's: a launch that skipped
    ``check_grid`` (counted here without running) is flagged."""
    from repro_torch.analysis import trace_audit
    from repro_torch.graph import traversal

    eng = TraversalEngine(trace_audit.default_audit_graph(), config=EngineConfig(device="cpu"))
    state = eng.init_state(list(trace_audit.AUDIT_SOURCES))
    plain = traversal.part_counts

    def unchecked(*args, **kwargs):
        part_count.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(traversal, "part_counts", unchecked)
    findings, stats, _ = trace_audit.audit_window(eng, state, 2, "control")
    assert stats["part_count_launches"] > 0 and stats["grid_checks"] == 0
    messages = [f.message for f in findings if f.rule == "JX03"]
    assert any("part_count launch(es) but 0 grid check(s)" in m for m in messages), messages
