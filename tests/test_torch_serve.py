"""Port parity, traversal serving: the cases of ``tests/test_serve.py`` run
through the JAX package and the port on the same graph and the same seeded
traces, and the ``ServiceReport``s must be equal.

Tolerance: none.  The clock is simulated, every number of a report derives
from the integer work counters and host-side numpy, and BFS/SSSP state is
bit-identical, so ``ServiceReport.asdict()`` is compared with ``==`` --
query records, cost report and percentiles included.  The queue, batcher,
scheduler and backfill units are held to the JAX tests' own assertions.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import repro.graph.generators as jgen
import repro.graph.partition as jpart
import repro.graph.program as jprog
import repro.serve as jserve
import repro_torch.graph.program as tprog
import repro_torch.serve as tserve
from repro.graph.config import EngineConfig as JaxConfig
from repro_torch.convert import partitioned_graph_from_numpy
from repro_torch.graph.config import EngineConfig
from repro_torch.graph.program import BfsProgram, SsspProgram
from repro_torch.graph.traversal import get_engine
from repro_torch.serve import (
    AdmissionQueue,
    CapacityScheduler,
    TraversalQuery,
    TraversalService,
    lane_key,
    lpt_makespan,
    lpt_rows,
    poisson_trace,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = EngineConfig(device="cpu")
N_PARTS = 4


def _carry(pj):
    g = pj.graph
    return partitioned_graph_from_numpy(
        g.n_vertices, g.src, g.dst, g.weights, pj.n_parts, pj.part_of_vertex
    )


@pytest.fixture(scope="module")
def pair():
    pj = jpart.hash_partition(jgen.rmat_graph(7, 4, seed=0), N_PARTS, seed=0)
    return pj, _carry(pj)


def _cfg(mod, **kw):
    kw.setdefault("s_batch", 4)
    kw.setdefault("window", 4)
    kw.setdefault("tau_scale", 1e3)
    return mod.ServiceConfig(**kw)


def _serve_both(pair, trace_of, mutations=(None, None), **kw):
    """Serve the same trace through both packages; ``trace_of(mod, programs)``
    builds it from a package's ``serve`` module and program classes."""
    pj, pt = pair
    svc_j = jserve.TraversalService(pj, config=_cfg(jserve, **kw), engine_config=JaxConfig())
    svc_t = TraversalService(pt, config=_cfg(tserve, **kw), engine_config=CPU)
    rj = svc_j.run(trace_of(jserve, jprog), mutations=mutations[0])
    rt = svc_t.run(trace_of(tserve, tprog), mutations=mutations[1])
    dj, dt = rj.asdict(), rt.asdict()
    assert dt["kind"] == "service_report"
    assert dj == dt
    assert rt.completed + rt.rejected + rt.dropped == rt.offered
    return rj, rt, svc_t


def _poisson(n, rate, seed, **kw):
    def trace_of(mod, programs):
        return mod.poisson_trace(n, rate, 128, seed=seed, **kw)
    return trace_of


# -- the service loop against the JAX package ---------------------------------


@pytest.mark.parametrize("static", [False, True], ids=["elastic", "static"])
@pytest.mark.parametrize("rate", [0.5, 4.0, 50.0])
def test_service_report_matches(pair, rate, static):
    kw = {"static_vms": 8} if static else {}
    rj, rt, _ = _serve_both(pair, _poisson(16, rate, seed=7), **kw)
    assert rt.completed == 16
    assert rt.capacity_peak <= 8
    if static:
        assert rt.capacity_mean == 8


def test_elastic_never_costs_more_than_static(pair):
    _, elastic, _ = _serve_both(pair, _poisson(16, 4.0, seed=7))
    _, static, _ = _serve_both(pair, _poisson(16, 4.0, seed=7), static_vms=8)
    assert elastic.cost.cost <= static.cost.cost


def test_per_program_lanes_match(pair):
    def trace_of(mod, programs):
        bfs = programs.BfsProgram()
        return tuple(
            (0.05 * i, mod.TraversalQuery(i + 1, bfs if i % 2 else None))
            for i in range(8)
        )

    fresh = (pair[0], _carry(pair[0]))
    _, rt, _ = _serve_both(fresh, trace_of)
    assert rt.completed == 8
    assert {r.lane for r in rt.queries} == {str(SsspProgram().key), str(BfsProgram().key)}
    assert len(fresh[1].__dict__["_traversal_engines"]) == 2  # one engine per lane


def test_requeue_then_drop_at_cap_matches(pair):
    _, rt, _ = _serve_both(
        pair, _poisson(6, 10.0, seed=6), superstep_cap=2, window=2, max_requeues=1
    )
    assert rt.requeued > 0 and rt.dropped > 0
    assert rt.completed + rt.dropped == rt.offered
    assert all(r.supersteps <= 2 for r in rt.queries)


def test_backpressure_matches(pair):
    _, rt, _ = _serve_both(pair, _poisson(30, 1e6, seed=5), queue_capacity=2)
    assert rt.rejected > 0


def test_deadlines_and_replay(pair):
    _, rt, _ = _serve_both(pair, _poisson(15, 8.0, seed=4, deadline=0.05))
    again = TraversalService(pair[1], config=_cfg(tserve), engine_config=CPU).run(
        poisson_trace(15, 8.0, 128, seed=4, deadline=0.05)
    )
    assert again == rt  # bit-for-bit, query records included


def test_poisson_trace_matches():
    tj = jserve.poisson_trace(20, 3.0, 1000, seed=11)
    tt = poisson_trace(20, 3.0, 1000, seed=11)
    assert [(t, q.source) for t, q in tj] == [(t, q.source) for t, q in tt]
    with pytest.raises(ValueError, match="rate"):
        poisson_trace(3, 0.0, 10)


def test_one_engine_per_lane_across_arrival_patterns(pair):
    """The counterpart of the JAX test's jit-cache probe: whatever the
    arrival pattern, a lane reuses one engine from the graph's cache, and
    the batch shape stays ``[s_batch, n]``."""
    pt = _carry(pair[0])
    svc = TraversalService(pt, config=_cfg(tserve), engine_config=CPU)
    svc.run(poisson_trace(12, 50.0, pt.graph.n_vertices, seed=1))  # burst
    engines = dict(pt.__dict__["_traversal_engines"])
    assert len(engines) == 1
    svc.run(poisson_trace(12, 0.5, pt.graph.n_vertices, seed=2))  # trickle
    svc.run(((0.0, TraversalQuery(3)),))  # one query, all-phantom padding
    assert dict(pt.__dict__["_traversal_engines"]) == engines


# -- units: admission queue, scheduler, backfill ------------------------------


def test_queue_backpressure_fifo_and_requeue():
    q = AdmissionQueue(2)
    assert q.offer(TraversalQuery(0), 0.0) is not None
    assert q.offer(TraversalQuery(1), 0.1) is not None
    assert q.offer(TraversalQuery(2), 0.2) is None  # full
    assert (q.admitted, q.rejected, len(q)) == (2, 1, 2)
    q.take(q.default_key, 1)
    assert q.offer(TraversalQuery(3), 0.3) is not None

    q = AdmissionQueue(16)
    sssp, bfs = SsspProgram(), BfsProgram()
    for i in range(4):
        q.offer(TraversalQuery(i, sssp), float(i))
        q.offer(TraversalQuery(10 + i, bfs), float(i))
    assert list(q.lanes()) == [str(sssp.key), str(bfs.key)]
    assert [r.query.source for r in q.take(str(sssp.key), 10)] == [0, 1, 2, 3]
    assert q.depth(str(bfs.key)) == 4

    q = AdmissionQueue(1)
    rec = q.offer(TraversalQuery(5), 0.0)
    q.take(q.default_key, 1)
    q.offer(TraversalQuery(6), 0.1)
    back = q.requeue(rec)  # exempt from the bound
    assert back.requeues == 1 and q.requeued == 1 and len(q) == 2
    got = q.take(lane_key(back.query, q.default_key), 2)
    assert [r.query.source for r in got] == [6, 5]
    with pytest.raises(ValueError):
        AdmissionQueue(0)


def test_scheduler_matches_and_drift_is_monotone():
    tau = np.array([3.0, 1.0, 4.0, 1.0, 5.0, 0.0])
    for n_vms in (1, 2, 3, 8):
        np.testing.assert_array_equal(lpt_rows(tau, n_vms), jserve.lpt_rows(tau, n_vms))
        assert lpt_makespan(tau, n_vms) == jserve.lpt_makespan(tau, n_vms)
    assert lpt_rows(tau, 3)[5] == -1 and lpt_makespan(tau, 1) == tau.sum()

    active = np.ones(N_PARTS, dtype=bool)
    decisions = []
    for mod in (jserve, tserve):
        sched = mod.CapacityScheduler(N_PARTS, max_vms=8, queue_weight=0.25)
        sched.observe(np.array([1.0, 2.0, 3.0, 4.0]))
        sched.observe(np.array([0.5, 3.0, 1.0, 0.0]))
        decisions.append([dataclasses.asdict(sched.decide(q, active)) for q in (0, 4, 16, 64)])
    assert decisions[0] == decisions[1]
    caps = [d["n_vms"] for d in decisions[1]]
    assert caps == sorted(caps) and caps[-1] == 8
    pinned = CapacityScheduler(N_PARTS, max_vms=8, static_vms=8)
    assert pinned.decide(0, active).n_vms == pinned.decide(100, active).n_vms == 8
    with pytest.raises(ValueError):
        CapacityScheduler(N_PARTS, min_vms=3, max_vms=2)


def _drain(eng, st, k=4):
    for _ in range(16):
        res = eng.run_window(st, k)
        st = res.state
        if bool(res.done.all()):
            return res
    raise AssertionError("did not converge")


def test_backfill_row_bit_identical_to_fresh_batch(pair):
    eng = get_engine(pair[1], config=CPU)
    st = eng.init_state(np.array([1, 2, 3, 4]))
    st = eng.run_window(st, 4).state  # mid-traversal surgery point
    before = st.dist.clone()
    st2 = eng.backfill_rows(st, [1], [7])
    assert bool((st.dist == before).all()), "backfill wrote into its input"
    res = _drain(eng, st2)
    fres = _drain(eng, eng.init_state(np.array([7] * 4)))
    np.testing.assert_array_equal(res.state.dist[1].numpy(), fres.state.dist[0].numpy())
    assert int(res.n_supersteps[1]) == int(fres.n_supersteps[0])


def test_backfill_deactivation_and_bad_rows(pair):
    eng = get_engine(pair[1], config=CPU)
    st = eng.run_window(eng.init_state(np.array([1, 2, 3, 4])), 2).state
    st = eng.backfill_rows(st, [2], [-1])
    assert bool((st.dist[2] == eng.program.identity.item()).all())
    assert not bool(st.frontier[2].any()) and int(st.n_supersteps[2]) == 0
    for rows, srcs in (([0, 0], [1, 2]), ([4], [1]), ([0, 1], [1])):
        with pytest.raises(ValueError):
            eng.backfill_rows(st, rows, srcs)


def test_serve_package_imports_with_jax_blocked():
    code = textwrap.dedent(
        """
        import sys
        for blocked in ("jax", "jaxlib", "repro"):
            sys.modules[blocked] = None
        import repro_torch.serve as serve
        q = serve.AdmissionQueue(4)
        q.offer(serve.TraversalQuery(0), 0.0)
        assert len(q) == 1
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=env, cwd=_ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
