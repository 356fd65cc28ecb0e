"""Port parity, the slice: ``repro_torch``'s dense ``TraversalEngine``
against the JAX package's engine on both its ``xla`` and
``pallas-interpret`` backends, for all four builtin programs.

Graphs are built by the JAX package and reach the port through
``repro_torch.convert``.  State is bit-identical for BFS, SSSP and WCC and
within ``rtol=1e-5, atol=1e-9`` for PageRank (float sums reassociate);
every counter, ``n_supersteps``, ``part_active_next`` and ``sg_active`` is
exact, with the reference's dtypes.
"""

import numpy as np
import pytest
import torch

import repro.graph.generators as jgen
import repro.graph.partition as jpart
import repro.graph.traversal as jtrav
from repro.graph.config import EngineConfig as JaxConfig
from repro.graph.program import BUILTIN_PROGRAMS as JAX_PROGRAMS
from repro_torch.convert import partitioned_graph_from_numpy, window_state_from_numpy
from repro_torch.graph import traversal as ttrav
from repro_torch.graph.config import EngineConfig
from repro_torch.graph.program import BUILTIN_PROGRAMS

PROGRAMS = sorted(BUILTIN_PROGRAMS)
JAX_BACKENDS = ["xla", "pallas-interpret"]
SOURCES = [0, 37, 200]  # S = 3
STATE_FIELDS = ("dist",)


def _graph(kind):
    if kind == "rmat9":
        g = jgen.weighted(jgen.rmat_graph(9, 8, seed=3), seed=2)
        return jpart.bfs_grow_partition(g, 5, seed=1)
    if kind == "road16":
        g = jgen.weighted(jgen.road_grid_graph(16, 16, seed=5), seed=4)
        return jpart.bfs_grow_partition(g, 5, seed=2)
    g = jgen.erdos_renyi_graph(300, 4.0, seed=9)
    return jpart.hash_partition(g, 5, seed=1)


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for kind in ("rmat9", "road16", "er-hash"):
        pj = _graph(kind)
        g = pj.graph
        pt = partitioned_graph_from_numpy(
            g.n_vertices, g.src, g.dst, g.weights, pj.n_parts, pj.part_of_vertex
        )
        out[kind] = (pj, pt)
    return out


def _engines(pair, name, backend, m_max=64, collect=False):
    pj, pt = pair
    je = jtrav.get_engine(
        pj, program=JAX_PROGRAMS[name](),
        config=JaxConfig(m_max=m_max, backend=backend, collect_subgraphs=collect),
    )
    te = ttrav.get_engine(
        pt, program=BUILTIN_PROGRAMS[name](),
        config=EngineConfig(device="cpu", m_max=m_max, collect_subgraphs=collect),
    )
    return je, te


def _assert_field(a, b, name, field):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{field}: {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{field}: {a.shape} != {b.shape}"
    if field in STATE_FIELDS and name == "pagerank":
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-9, err_msg=field)
    else:
        np.testing.assert_array_equal(b, a, err_msg=field)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("name", PROGRAMS)
@pytest.mark.parametrize("kind", ["rmat9", "road16"])
def test_run_matches_jax_engine(graphs, kind, name, backend):
    je, te = _engines(graphs[kind], name, backend)
    rj, rt = je.run(SOURCES), te.run(SOURCES)
    assert rt._fields == rj._fields
    for field in rj._fields:
        _assert_field(getattr(rj, field), getattr(rt, field), name, field)
    assert te.host_syncs > 0


@pytest.mark.parametrize("name", ["bfs", "wcc"])
def test_run_collect_subgraphs_matches_jax_engine(graphs, name):
    je, te = _engines(graphs["er-hash"], name, "xla", collect=True)
    rj, rt = je.run(SOURCES), te.run(SOURCES)
    assert rt.sg_active.shape[2] == graphs["er-hash"][1].n_subgraphs
    for field in rj._fields:
        _assert_field(getattr(rj, field), getattr(rt, field), name, field)


def _window_fields(wj, wt, name):
    for field in wj._fields:
        if field == "state":
            for f, a, b in zip(wj.state._fields, wj.state, wt.state):
                _assert_field(a, b.numpy(), name, "dist" if f == "dist" else f)
        else:
            _assert_field(getattr(wj, field), getattr(wt, field), name, field)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("name", PROGRAMS)
def test_chained_run_window_matches_jax_engine(graphs, name, backend):
    je, te = _engines(graphs["rmat9"], name, backend)
    sj, st = je.init_state(SOURCES), te.init_state(SOURCES)
    for k in (1, 2, 3, 64):
        wj, wt = je.run_window(sj, k), te.run_window(st, k)
        _window_fields(wj, wt, name)
        sj, st = wj.state, wt.state
    assert wt.done.all()


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("name", PROGRAMS)
def test_backfill_rows_matches_jax_engine(graphs, name, backend):
    je, te = _engines(graphs["rmat9"], name, backend)
    wj = je.run_window(je.init_state(SOURCES), 2)
    wt = te.run_window(te.init_state(SOURCES), 2)
    bj = je.backfill_rows(wj.state, [2, 0], [5, -1])
    bt = te.backfill_rows(wt.state, [2, 0], [5, -1])
    for f, a, b in zip(bj._fields, bj, bt):
        _assert_field(a, b.numpy(), name, "dist" if f == "dist" else f)
    _window_fields(je.run_window(bj, 64), te.run_window(bt, 64), name)
    assert te.backfill_rows(bt, [], []) is bt
    with pytest.raises(ValueError, match="unique"):
        te.backfill_rows(bt, [1, 1], [0, 0])


def test_window_state_from_numpy_resumes_a_jax_window(graphs):
    je, te = _engines(graphs["road16"], "sssp", "xla")
    wj = je.run_window(je.init_state(SOURCES), 3)
    st = window_state_from_numpy(
        np.asarray(wj.state.dist), np.asarray(wj.state.frontier),
        np.asarray(wj.state.n_supersteps), "cpu",
    )
    _window_fields(je.run_window(wj.state, 64), te.run_window(st, 64), "sssp")


def test_not_converged_raises_like_the_jax_engine(graphs):
    je, te = _engines(graphs["road16"], "bfs", "xla", m_max=3)
    with pytest.raises(jtrav.TraversalNotConverged) as ej:
        je.run(SOURCES)
    with pytest.raises(ttrav.TraversalNotConverged) as et:
        te.run(SOURCES)
    assert str(et.value) == str(ej.value)
    for field in ej.value.result._fields:
        _assert_field(
            getattr(ej.value.result, field), getattr(et.value.result, field),
            "bfs", field,
        )


def test_asdict_matches_jax_surface(graphs):
    je, te = _engines(graphs["er-hash"], "wcc", "xla")
    dj, dt = je.run([1]).asdict(), te.run([1]).asdict()
    assert list(dt) == list(dj)
    assert dt["schema_version"] == dj["schema_version"]
    assert dt["kind"] == dj["kind"] == "traversal_result"


@pytest.mark.parametrize("name", PROGRAMS)
def test_numpy_oracles_match_jax_package(graphs, name):
    pj, pt = graphs["road16"]
    if name == "wcc":
        np.testing.assert_array_equal(ttrav.reference_wcc(pt), jtrav.reference_wcc(pj))
    elif name == "pagerank":
        np.testing.assert_array_equal(
            ttrav.reference_pagerank(pt), jtrav.reference_pagerank(pj)
        )
    else:
        fn = f"reference_{name}"
        np.testing.assert_array_equal(
            getattr(ttrav, fn)(pt, 7), getattr(jtrav, fn)(pj, 7)
        )


def test_default_config_targets_cuda_and_raises_without_it(graphs):
    assert EngineConfig().device == "cuda"
    assert EngineConfig().backend is None
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA refusal cannot show")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrav.TraversalEngine(graphs["er-hash"][1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrav.get_engine(graphs["er-hash"][1])


def test_cuda_backend_on_cpu_device_raises(graphs):
    with pytest.raises(ValueError, match="CUDA device"):
        ttrav.TraversalEngine(
            graphs["er-hash"][1], config=EngineConfig(device="cpu", backend="cuda")
        )


def test_device_caches_are_keyed_by_device(graphs):
    pt = graphs["er-hash"][1]
    te = ttrav.get_engine(pt, config=EngineConfig(device="cpu"))
    assert te.backend == "torch" and te.device == torch.device("cpu")
    cache = pt.__dict__["_traversal_device_arrays"]
    assert list(cache) == [("cpu",)]
    assert all(t.device.type == "cpu" for t in cache[("cpu",)])
    assert ttrav.get_engine(pt, config=EngineConfig(device="cpu")) is te
