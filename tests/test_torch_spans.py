"""The dense engine's spans and its scan counter, on the CPU through the
plain backend: under a running ``torch.profiler`` one traversal records the
span tree the engine documents, each span under its parent and as many of
each as the result's iteration counts give; with no profiler it opens none
and computes the same result bit for bit; ``scan_elems`` is the rows × n
the shapes give."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.spans as spans_mod
from repro_torch.graph import traversal as ttrav
from repro_torch.graph.config import EngineConfig
from repro_torch.graph.generators import rmat_graph, weighted
from repro_torch.graph.partition import bfs_grow_partition
from repro_torch.graph.program import BUILTIN_PROGRAMS
from repro_torch.spans import span

SOURCES = [0, 37, 200]


@pytest.fixture(scope="module")
def pg():
    return bfs_grow_partition(weighted(rmat_graph(9, 8, seed=3), seed=2), 5, seed=1)


def _engine(pg, name):
    # a fresh engine a test, so that its counters start at 0
    return ttrav.TraversalEngine(
        pg, program=BUILTIN_PROGRAMS[name](), config=EngineConfig(device="cpu", m_max=64)
    )


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [ev for ev in prof.events() if ev.name.startswith("engine.")]


def _parent(ev):
    """The nearest enclosing span, through the profiler's parent links."""
    p = ev.cpu_parent
    while p is not None and not p.name.startswith("engine."):
        p = p.cpu_parent
    return p.name if p is not None else None


def _tree(events) -> dict:
    """``{(name, parent span): count}``."""
    out = {}
    for ev in events:
        key = (ev.name, _parent(ev))
        out[key] = out.get(key, 0) + 1
    return out


def _results_equal(a, b):
    for x, y, field in zip(a, b, a._fields):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=field)


def test_sssp_run_records_the_span_tree(pg):
    eng = _engine(pg, "sssp")
    res, events = _profiled(lambda: eng.run(SOURCES))
    closures = int(np.asarray(res.inner_iters).max(axis=0).sum())
    steps = int(np.asarray(res.n_supersteps).max())
    assert closures > steps > 1
    assert _tree(events) == {
        ("engine.run", None): 1,
        ("engine.init", "engine.run"): 1,
        ("engine.window", "engine.run"): 1,
        ("engine.pull", "engine.run"): 1,
        # each closure condition, and each superstep condition and the last
        ("engine.host_read", "engine.window"): closures + 2 * steps + 1,
        ("engine.closure", "engine.window"): closures,
        ("engine.exchange", "engine.window"): steps,
        ("engine.gather", "engine.closure"): closures,
        ("engine.relax", "engine.closure"): closures,
        ("engine.counters", "engine.closure"): closures,
        ("engine.gather", "engine.exchange"): steps,
        ("engine.relax", "engine.exchange"): steps,
        ("engine.counters", "engine.exchange"): steps,
        ("engine.counters", "engine.window"): 1,
    }
    counters = sum(1 for ev in events if ev.name == "engine.counters")
    assert counters == closures + steps + 1
    # every loop condition read is a span, the run's pull is not a read
    assert sum(1 for ev in events if ev.name == "engine.host_read") == eng.host_syncs - 1
    assert not any("relax_" in ev.name for ev in events)


def test_stationary_superstep_has_gathers_relax_and_counters_only(pg):
    eng = _engine(pg, "pagerank")
    res, events = _profiled(lambda: eng.run(SOURCES[:1]))
    steps = int(np.asarray(res.n_supersteps).max())
    assert steps > 1
    tree = _tree(events)
    assert tree[("engine.gather", "engine.window")] == 2 * steps
    assert tree[("engine.relax", "engine.window")] == 2 * steps
    assert tree[("engine.counters", "engine.window")] == steps + 1
    assert not {name for name, _ in tree} & {"engine.closure", "engine.exchange"}
    assert eng.scan_elems == (3 * steps + 1) * 1 * eng.n


def test_run_window_wraps_its_pull(pg):
    eng = _engine(pg, "sssp")
    state = eng.init_state(SOURCES)
    _, events = _profiled(lambda: eng.run_window(state, 2))
    tree = _tree(events)
    assert tree[("engine.window", None)] == 1 and tree[("engine.pull", None)] == 1
    assert ("engine.run", None) not in tree


def test_no_profiler_no_span_and_the_same_result(pg, monkeypatch):
    opened = []
    fast = spans_mod._RecordFunctionFast

    def counting(name):
        opened.append(name)
        return fast(name)

    monkeypatch.setattr(spans_mod, "_RecordFunctionFast", counting)
    plain = _engine(pg, "sssp").run(SOURCES)
    assert opened == []
    profiled, events = _profiled(lambda: _engine(pg, "sssp").run(SOURCES))
    assert len(opened) == len(events) > 0
    _results_equal(plain, profiled)


@pytest.mark.parametrize("sources", [[0], SOURCES])
def test_scan_elems_is_rows_times_n_of_every_scan(pg, sources):
    eng = _engine(pg, "sssp")
    res = eng.run(sources)
    closures = int(np.asarray(res.inner_iters).max(axis=0).sum())
    steps = int(np.asarray(res.n_supersteps).max())
    s, n = len(sources), eng.n
    # a closure iteration scans [2S, n], an exchange [S, n], the window's end [S, n]
    assert eng.scan_elems == (2 * closures + steps + 1) * s * n
    before = eng.scan_elems
    eng.run_window(eng.init_state(sources), 1)
    assert eng.scan_elems > before


def test_span_is_a_nullcontext_off_and_a_range_on():
    assert span("engine.x") is spans_mod._OFF
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("engine.x"):
            torch.ones(3).sum()
    evs = [ev for ev in prof.events() if ev.name == "engine.x"]
    assert len(evs) == 1 and not evs[0].is_user_annotation
    assert any(ev.cpu_parent is evs[0] for ev in prof.events())
