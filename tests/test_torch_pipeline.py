"""Port parity, the paper's pipeline: BSP traces from the port's engine,
the time function A, every placement strategy's ``CostReport``, the
activation sessions and the metagraph prediction equal the JAX package's on
the same graph (exactly: the counters are integers and everything after
them is the same host-side numpy).
"""

import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro.core.activation as jact
import repro.graph.bsp as jbsp
import repro.graph.generators as jgen
import repro.graph.partition as jpart
import repro_torch.core as tcore
import repro_torch.core.activation as tact
import repro_torch.graph.bsp as tbsp
from repro.graph.config import EngineConfig as JaxConfig
from repro.graph.program import BUILTIN_PROGRAMS as JAX_PROGRAMS
from repro_torch.convert import partitioned_graph_from_numpy
from repro_torch.graph.config import EngineConfig
from repro_torch.graph.program import BUILTIN_PROGRAMS

CPU = EngineConfig(device="cpu")
BC_SOURCES = [0, 37, 200]


@pytest.fixture(scope="module")
def pair():
    g = jgen.road_grid_graph(16, 16, seed=5)
    pj = jpart.bfs_grow_partition(g, 5, seed=2)
    pt = partitioned_graph_from_numpy(
        g.n_vertices, g.src, g.dst, g.weights, pj.n_parts, pj.part_of_vertex
    )
    return pj, pt


@pytest.fixture(scope="module")
def time_functions(pair):
    pj, pt = pair
    tj = jbsp.run_bc_forward(pj, BC_SOURCES, config=JaxConfig())
    tt = tbsp.run_bc_forward(pt, BC_SOURCES, config=CPU)
    return (
        jcore.TimeFunction.from_trace(tj).scaled_to_tmin(21.0),
        tcore.TimeFunction.from_trace(tt).scaled_to_tmin(21.0),
    )


def _assert_trace_equal(tj, tt):
    for f in dataclasses.fields(tj):
        a, b = getattr(tj, f.name), getattr(tt, f.name)
        if f.name == "active_subgraphs":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert tj.mean_active_fraction() == tt.mean_active_fraction()


def test_run_sssp_trace_and_dist_match(pair):
    pj, pt = pair
    dj, tj = jbsp.run_sssp(pj, 7)
    dt, tt = tbsp.run_sssp(pt, 7, config=CPU)
    np.testing.assert_array_equal(np.asarray(dj), dt)
    assert len(tt.active_subgraphs) == tt.n_supersteps > 0
    _assert_trace_equal(tj, tt)


def test_run_bc_forward_trace_matches(pair):
    pj, pt = pair
    _assert_trace_equal(
        jbsp.run_bc_forward(pj, BC_SOURCES),
        tbsp.run_bc_forward(pt, BC_SOURCES, config=CPU),
    )


@pytest.mark.parametrize("name", sorted(BUILTIN_PROGRAMS))
def test_run_program_traces_match(pair, name):
    pj, pt = pair
    vj, tjs = jbsp.run_program(pj, JAX_PROGRAMS[name](), sources=iter([3, 9]))
    vt, tts = tbsp.run_program(pt, BUILTIN_PROGRAMS[name](), sources=iter([3, 9]),
                               config=CPU)
    if name == "pagerank":
        np.testing.assert_allclose(vt, np.asarray(vj), rtol=1e-5, atol=1e-9)
    else:
        np.testing.assert_array_equal(vt, np.asarray(vj))
    assert len(tts) == len(tjs) == 2
    for tj, tt in zip(tjs, tts):
        _assert_trace_equal(tj, tt)


def test_concat_traces_matches(pair):
    pj, pt = pair
    _, a = jbsp.run_sssp(pj, 1)
    _, b = tbsp.run_sssp(pt, 1, config=CPU)
    _assert_trace_equal(jbsp.concat_traces([a, a]), tbsp.concat_traces([b, b]))


def test_time_function_matches(time_functions):
    tfj, tft = time_functions
    np.testing.assert_array_equal(tfj.tau, tft.tau)
    assert tft.t_min() == tfj.t_min() == pytest.approx(21.0)
    np.testing.assert_array_equal(tfj.decay_rates(), tft.decay_rates())


@pytest.mark.parametrize("strategy", sorted(tcore.STRATEGIES))
def test_every_strategy_cost_report_matches(time_functions, strategy):
    tfj, tft = time_functions
    pl_j = jcore.STRATEGIES[strategy](tfj)
    pl_t = tcore.STRATEGIES[strategy](tft)
    pl_t.validate()
    np.testing.assert_array_equal(pl_j.vm_of, pl_t.vm_of)
    assert (pl_j.optimal, pl_j.pinned, pl_j.always_on) == (
        pl_t.optimal, pl_t.pinned, pl_t.always_on
    )
    rj = jcore.evaluate(pl_j, jcore.BillingModel(delta=60.0))
    rt = tcore.evaluate(pl_t, tcore.BillingModel(delta=60.0))
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)


def test_data_movement_cost_report_matches(pair, time_functions):
    pj, pt = pair
    tfj, tft = time_functions
    rj = jcore.evaluate(
        jcore.opt_placement(tfj), jcore.BillingModel(delta=60.0),
        data_movement=True, partition_bytes=pj.partition_bytes() * 2000.0,
    )
    rt = tcore.evaluate(
        tcore.opt_placement(tft), tcore.BillingModel(delta=60.0),
        data_movement=True, partition_bytes=pt.partition_bytes() * 2000.0,
    )
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)


@pytest.mark.parametrize(
    "rule", ["gap_le_delta", "exact_greedy", "always_stop", "always_keep"]
)
def test_activation_sessions_match(rule):
    rng = np.random.default_rng(0)
    busy = rng.uniform(0, 30, (12, 4)) * (rng.random((12, 4)) < 0.5)
    durations = rng.uniform(5, 40, 12)
    sj = jact.plan_sessions(busy, durations, 60.0, rule=rule)
    st = tact.plan_sessions(busy, durations, 60.0, rule=rule)
    assert (st.sessions, st.n_starts) == (sj.sessions, sj.n_starts)
    assert st.billed_quanta(60.0) == sj.billed_quanta(60.0)


def test_metagraph_and_prediction_match(pair):
    pj, pt = pair
    mj, mt = jcore.build_metagraph(pj), tcore.build_metagraph(pt)
    for f in dataclasses.fields(mj):
        np.testing.assert_array_equal(getattr(mj, f.name), getattr(mt, f.name))
    tfj, sj = jcore.predict_time_function(pj, 0, mg=mj)
    tft, st = tcore.predict_time_function(pt, 0, mg=mt)
    np.testing.assert_array_equal(tfj.tau, tft.tau)
    np.testing.assert_array_equal(sj.first_visit, st.first_visit)
    np.testing.assert_array_equal(sj.active, st.active)
    assert sj.n_supersteps == st.n_supersteps
