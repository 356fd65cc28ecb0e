"""Port parity, the elastic executor and the online re-planner: every case of
``tests/test_elastic.py`` and ``tests/test_replan.py`` runs through the JAX
package and the port on the same graph (carried across by
``convert.partitioned_graph_from_numpy``), and the results must agree.

Tolerances: the ``ExecutionReport`` is equal field by field except
``wall_seconds`` -- tau, cost, migration bytes, residency and host syncs
exactly (the counters are integers and everything after them is the same
host-side numpy).  State is bit-identical for BFS, SSSP and WCC, and within
rtol=1e-5, atol=1e-9 for PageRank (float sums reassociate).  The re-planner
is host numpy on both sides and must agree exactly.
"""

import dataclasses
import math

import numpy as np
import pytest

import repro.core as jcore
import repro.core.replan as jreplan
import repro.graph.bsp as jbsp
import repro.graph.generators as jgen
import repro.graph.partition as jpart
import repro.graph.traversal as jtrav
import repro_torch.core as tcore
import repro_torch.core.replan as treplan
import repro_torch.graph.bsp as tbsp
from repro.core.elastic import ElasticBSPExecutor as JaxExecutor
from repro.core.metagraph import predict_time_function as jax_predict
from repro.data.workloads import paper_workloads as jax_workloads
from repro.graph.config import EngineConfig as JaxConfig
from repro.graph.program import BUILTIN_PROGRAMS as JAX_PROGRAMS
from repro_torch.convert import partitioned_graph_from_numpy
from repro_torch.core.elastic import ElasticBSPExecutor
from repro_torch.core.metagraph import predict_time_function
from repro_torch.data import paper_workloads
from repro_torch.graph.config import EngineConfig
from repro_torch.graph.program import BUILTIN_PROGRAMS
from repro_torch.graph.traversal import get_engine, make_superstep_fn

CPU = EngineConfig(device="cpu")
WRONG_SOURCE, REAL_SOURCE = 7, 200
MODES = ("static", "replan", "replan+sketch")


def _carry(pj):
    g = pj.graph
    return partitioned_graph_from_numpy(
        g.n_vertices, g.src, g.dst, g.weights, pj.n_parts, pj.part_of_vertex
    )


@pytest.fixture(scope="module")
def er_pair():
    """The replan graph of ``tests/test_elastic.py``: 400 vertices, P=5."""
    pj = jpart.bfs_grow_partition(jgen.erdos_renyi_graph(400, 4.0, seed=5), 5, seed=6)
    return pj, _carry(pj)


@pytest.fixture(scope="module")
def grid_pair():
    """The long-diameter grid of ``tests/test_elastic.py``: 625 vertices, P=6."""
    pj = jpart.bfs_grow_partition(jgen.road_grid_graph(25, 25, seed=2), 6, seed=3)
    return pj, _carry(pj)


def _time_functions(pair, source):
    pj, pt = pair
    _, tj = jbsp.run_sssp(pj, source)
    _, tt = tbsp.run_sssp(pt, source, config=CPU)
    return jcore.TimeFunction.from_trace(tj), tcore.TimeFunction.from_trace(tt)


def _plans(pair, source, strategy):
    tfj, tft = _time_functions(pair, source)
    pj, pt = jcore.STRATEGIES[strategy](tfj), tcore.STRATEGIES[strategy](tft)
    np.testing.assert_array_equal(pj.vm_of, pt.vm_of)
    return pj, pt


def assert_reports_equal(rj, rt, *, rtol=None):
    """Field by field, except ``wall_seconds``; ``rtol`` set only for the
    state of a stationary program."""
    assert [f.name for f in dataclasses.fields(rj)] == [
        f.name for f in dataclasses.fields(rt)
    ]
    for f in dataclasses.fields(rj):
        a, b = getattr(rj, f.name), getattr(rt, f.name)
        if f.name == "wall_seconds":
            continue
        if f.name == "dist":
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            if rtol is None:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-9)
        elif f.name == "actual_tau":
            np.testing.assert_array_equal(a.tau, b.tau)
        elif f.name == "cost":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f"{f.name}: {a} != {b}"
    dj, dt = rj.asdict(), rt.asdict()
    assert list(dj) == list(dt)
    assert dt["kind"] == "execution_report" and dt["schema_version"] == dj["schema_version"]


def _run_both(pair, source, plans, *, window, program=None, strategy=None,
              replan=False, sketch=(None, None)):
    """One run per package; ``strategy`` names the re-planning strategy,
    ``sketch`` is ``(jax, port)``."""
    pj, pt = pair
    jprog = None if program is None else JAX_PROGRAMS[program]()
    tprog = None if program is None else BUILTIN_PROGRAMS[program]()
    rj = JaxExecutor(pj, program=jprog, config=JaxConfig(window=window)).run(
        source, plans[0], replan=replan, sketch=sketch[0],
        strategy_fn=None if strategy is None else jcore.STRATEGIES[strategy],
    )
    ex = ElasticBSPExecutor(pt, program=tprog, config=CPU.replace(window=window))
    syncs0 = ex.engine.host_syncs
    rt = ex.run(
        source, plans[1], replan=replan, sketch=sketch[1],
        strategy_fn=None if strategy is None else tcore.STRATEGIES[strategy],
    )
    # the engine's loop conditions read the card besides the bulk pulls
    assert ex.engine.host_syncs - syncs0 >= rt.host_syncs + rt.n_supersteps - 1
    return rj, rt


# -- the executor, every strategy x replan mode x window ----------------------


@pytest.mark.parametrize("window", [1, 3, 8])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("strategy", sorted(tcore.STRATEGIES))
def test_execution_report_matches(er_pair, strategy, mode, window):
    """A plan for the wrong source, executed from the real one (the
    replan-recovery case): with the re-planner off the plan runs out and
    the fallback pins the active partitions; on, the strategy re-plans."""
    plans = _plans(er_pair, WRONG_SOURCE, strategy)
    sketch = (None, None)
    if mode == "replan+sketch":
        sketch = (
            jax_predict(er_pair[0], REAL_SOURCE)[0],
            predict_time_function(er_pair[1], REAL_SOURCE)[0],
        )
    rj, rt = _run_both(
        er_pair, REAL_SOURCE, plans, window=window,
        strategy=None if mode == "static" else strategy,
        replan=mode != "static", sketch=sketch,
    )
    assert_reports_equal(rj, rt)
    np.testing.assert_array_equal(rt.dist, jtrav.reference_bfs(er_pair[0], REAL_SOURCE))
    assert rt.window == window and rt.relayouts == rt.relayouts_skipped == 0
    if mode != "static":
        assert rt.replans >= 1


@pytest.mark.parametrize("name", sorted(BUILTIN_PROGRAMS))
def test_execution_report_matches_per_program(er_pair, name):
    plans = _plans(er_pair, 0, "ffd")
    rj, rt = _run_both(
        er_pair, 0, plans, window=3, program=name,
        strategy="ffd", replan=True,
    )
    assert_reports_equal(rj, rt, rtol=1e-5 if name == "pagerank" else None)


def test_single_divergence_triggers_exactly_one_replan(er_pair):
    plans = _plans(er_pair, WRONG_SOURCE, "ffd")
    assert er_pair[1].part_of_vertex[WRONG_SOURCE] != er_pair[1].part_of_vertex[REAL_SOURCE]
    for window in (1, 4):
        rj, rt = _run_both(
            er_pair, REAL_SOURCE, plans, window=window,
            strategy="ffd", replan=True,
        )
        assert_reports_equal(rj, rt)
        assert rt.replans == 1


@pytest.mark.parametrize("strategy", ["ffd", "mfp"])
def test_migration_pricing_and_host_syncs_match(grid_pair, strategy):
    """The grid migrates under FFD and never under the pinned MF-P; either
    way the port bills the same bytes and seconds, and 8-superstep windows
    cost at most ceil(S/8) + 1 bulk pulls."""
    plans = _plans(grid_pair, 0, strategy)
    rj, rt = _run_both(grid_pair, 0, plans, window=8)
    assert_reports_equal(rj, rt)
    assert rt.host_syncs <= math.ceil(rt.n_supersteps / 8) + 1
    assert rt.cost.migration_secs == pytest.approx(
        rt.migration_bytes / tcore.BillingModel().move_bandwidth
    )
    if strategy == "ffd":
        assert rt.n_migrations > 0 and rt.migration_bytes > 0
    else:
        assert rt.n_migrations == rt.migration_bytes == 0


def test_windows_do_not_change_the_math(er_pair):
    plans = _plans(er_pair, 0, "ffd")
    base = ElasticBSPExecutor(er_pair[1], config=CPU.replace(window=1)).run(0, plans[1])
    _, tft = _time_functions(er_pair, 0)
    np.testing.assert_allclose(base.actual_tau.tau, tft.tau)
    assert base.host_syncs == base.n_supersteps + 1
    for k in (4, 16):
        rep = ElasticBSPExecutor(er_pair[1], config=CPU.replace(window=k)).run(0, plans[1])
        np.testing.assert_array_equal(rep.dist, base.dist)
        np.testing.assert_array_equal(rep.actual_tau.tau, base.actual_tau.tau)
        assert rep.n_supersteps == base.n_supersteps


def test_moves_scheduled_past_convergence_match(er_pair):
    plans = _plans(er_pair, 0, "ffd")
    n_parts = er_pair[1].n_parts
    extra = np.tile((np.arange(n_parts, dtype=np.int64)[None] + 1) % n_parts, (8, 1))
    padded = tuple(
        mod.Placement(
            strategy=p.strategy,
            tau=np.vstack([p.tau, np.zeros((8, n_parts))]),
            vm_of=np.vstack([p.vm_of, extra]),
        )
        for mod, p in zip((jcore, tcore), plans)
    )
    rj, rt = _run_both(er_pair, 0, padded, window=16)
    assert_reports_equal(rj, rt)
    base = ElasticBSPExecutor(er_pair[1], config=CPU.replace(window=16)).run(0, plans[1])
    assert (rt.n_supersteps, rt.n_migrations, rt.migration_bytes) == (
        base.n_supersteps, base.n_migrations, base.migration_bytes
    )


# -- the one-superstep oracle and the paper workload ---------------------------


def test_make_superstep_fn_matches(er_pair):
    import jax.numpy as jnp

    pj, pt = er_pair
    fj = jtrav.make_superstep_fn(pj)
    ft = make_superstep_fn(pt, config=CPU)
    n = pt.graph.n_vertices
    dist = np.full(n, np.inf, np.float32)
    dist[0] = 0.0
    frontier = np.zeros(n, bool)
    frontier[0] = True
    dj, fr_j = jnp.asarray(dist), jnp.asarray(frontier)
    import torch

    dt, fr_t = torch.as_tensor(dist), torch.as_tensor(frontier)
    steps = 0
    while frontier.any():
        rj, rt = fj(dj, fr_j), ft(dt, fr_t)
        for field in rj._fields:
            a, b = np.asarray(getattr(rj, field)), getattr(rt, field).numpy()
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        dj, fr_j, dt, fr_t = rj.dist, rj.next_frontier, rt.dist, rt.next_frontier
        frontier = rt.next_frontier.numpy()
        steps += 1
    assert steps > 2
    np.testing.assert_array_equal(dt.numpy(), jtrav.reference_bfs(pj, 0))


def test_paper_workload_livj_matches(tmp_path):
    (wj,) = jax_workloads(("LIVJ/8P",), cache_dir=str(tmp_path / "jax"))
    (wt,) = paper_workloads(("LIVJ/8P",), cache_dir=str(tmp_path / "torch"), config=CPU)
    np.testing.assert_array_equal(wj.pg.part_of_vertex, wt.pg.part_of_vertex)
    np.testing.assert_array_equal(wj.tf.tau, wt.tf.tau)
    np.testing.assert_array_equal(wj.partition_bytes, wt.partition_bytes)
    assert wt.tf.t_min() == pytest.approx(21.0)
    assert (wt.name, wt.source, wt.n_parts) == ("LIVJ/8P", 0, 8)
    assert list((tmp_path / "torch").iterdir()), "the port wrote no cache of its own"
    (again,) = paper_workloads(("LIVJ/8P",), cache_dir=str(tmp_path / "torch"), config=CPU)
    np.testing.assert_array_equal(again.tf.tau, wt.tf.tau)


# -- the online re-planner (host numpy on both sides) --------------------------


SKETCH = np.array([[1.0, 8.0], [0.5, 2.0], [0.0, 0.5]])
EXTRAPOLATE_CASES = {
    # name: (observed, active_next, horizon, config kwargs, sketch)
    "per-partition-rate": ([[8.0, 1.0], [4.0, 0.9]], [True, True], 3,
                           {"activation_floor": 0.0}, None),
    "floors-inactive": ([[2.0, 0.0, 0.0]], [True, False, False], 4, {}, None),
    "no-observations": (np.zeros((0, 3)), [False, True, True], 2, {}, None),
    "sketch-rates": ([[8.0, 0.0], [4.0, 2.0]], [True, True], 3,
                     {"activation_floor": 0.0}, SKETCH),
    "sketch-floors": ([[4.0, 0.0, 0.0]], [True, False, False], 2, {},
                      [[0.0, 8.0, 1.0], [0.0, 8.0, 1.0]]),
}


@pytest.mark.parametrize("case", sorted(EXTRAPOLATE_CASES))
def test_extrapolate_and_decay_horizon_match(case):
    observed, active, horizon, kw, sketch = EXTRAPOLATE_CASES[case]
    observed, active = np.asarray(observed, np.float64), np.asarray(active)
    out = []
    for mod, tf in ((jreplan, jcore.TimeFunction), (treplan, tcore.TimeFunction)):
        cfg = mod.ReplanConfig(**kw)
        sk = None if sketch is None else tf(np.asarray(sketch, np.float64))
        out.append((
            mod.extrapolate_tau(observed, active, horizon, cfg, sk),
            mod.decay_horizon(observed, active, cfg, sk),
        ))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    assert (out[1][0] >= 0).all()


@pytest.mark.parametrize("strategy", [None, "ffd"])
@pytest.mark.parametrize("sketched", [False, True])
def test_replanner_splice_matches(strategy, sketched):
    n_parts = 3
    obs = np.array([[1.0, 0.0, 0.0], [0.5, 2.0, 0.0]])
    old = np.full((4, n_parts), -1, dtype=np.int64)
    old[:, 0] = 0
    active = np.array([False, True, True])
    out = []
    for mod, core in ((jreplan, jcore), (treplan, tcore)):
        sk = core.TimeFunction(np.tile([[4.0, 2.0, 1.0]], (6, 1))) if sketched else None
        fn = None if strategy is None else core.STRATEGIES[strategy]
        rp = mod.OnlineReplanner(n_parts, fn, mod.ReplanConfig(min_horizon=8), sketch=sk)
        rp.observe(obs)
        first = rp.replan(old, 2, active)
        rp.reprime(np.array([3.0, 1.0, 0.0]))
        out.append((first, rp.replan(old, 2, active), rp.sketch.tau))
        with pytest.raises(ValueError, match="observed prefix"):
            rp.replan(old, 3, active)
        with pytest.raises(ValueError, match="part_activity"):
            rp.reprime(np.ones(n_parts + 1))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[1][0][:2], old[:2])
    assert out[1][0].shape[0] - 2 >= 8
    if strategy is None:  # the fallback pins the active partitions throughout
        rows = out[1][0].shape[0] - 2
        np.testing.assert_array_equal(out[1][0][2:], np.tile([-1, 0, 1], (rows, 1)))
    else:  # the activation floor keeps every partition placed
        assert (out[1][0][2:] >= 0).all()


def test_replan_config_for_program_matches():
    for name in sorted(BUILTIN_PROGRAMS):
        assert dataclasses.asdict(
            treplan.ReplanConfig.for_program(BUILTIN_PROGRAMS[name]())
        ) == dataclasses.asdict(jreplan.ReplanConfig.for_program(JAX_PROGRAMS[name]()))
    with pytest.raises(ValueError, match="partitions"):
        treplan.extrapolate_tau(
            np.array([[1.0, 1.0]]), np.array([True, True]), 2,
            sketch=tcore.TimeFunction(np.ones((2, 3))),
        )


def test_executor_engine_is_the_cached_one(er_pair):
    ex = ElasticBSPExecutor(er_pair[1], config=CPU)
    assert ex.engine is get_engine(er_pair[1], program=ex.program, config=CPU)
    assert ex.devices == [ex.engine.device] and ex.engine.device_of_part is None
