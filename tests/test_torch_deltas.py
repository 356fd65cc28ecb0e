"""Port parity, graph mutations: the dense cases of ``tests/test_deltas.py``
run through the JAX package and the port on the same graphs and the same
seeded delta buffers, and must agree.

Tolerance: none.  Buffer validation raises the same errors; merged edge
lists, repartition maps, moves and penalties are host numpy on both sides
and equal exactly; session, executor and service runs across a merge give
bit-identical BFS/SSSP state, equal ``ExecutionReport``s (except
``wall_seconds``) and equal ``ServiceReport.asdict()``.  The mesh half of
``graph.deltas`` (the incremental layout merge) is not ported yet.
"""

import numpy as np
import pytest
import torch

import repro.core.placement as jplace
import repro.core.repartition as jrep
import repro.graph.bsp as jbsp
import repro.graph.deltas as jdeltas
import repro.graph.generators as jgen
import repro.graph.partition as jpart
import repro.graph.session as jsession
import repro.serve as jserve
import repro_torch.core.placement as tplace
import repro_torch.core.repartition as trep
import repro_torch.graph.bsp as tbsp
import repro_torch.graph.deltas as tdeltas
import repro_torch.serve as tserve
from repro.core.timing import TimeFunction as JaxTimeFunction
from repro.graph.config import EngineConfig as JaxConfig
from repro.graph.structs import PartitionedGraph as JaxPartitionedGraph
from repro_torch.convert import partitioned_graph_from_numpy
from repro_torch.core.timing import TimeFunction
from repro_torch.graph.config import EngineConfig
from repro_torch.graph.program import PageRankProgram
from repro_torch.graph.session import open_session
from repro_torch.graph.traversal import get_engine
CPU = EngineConfig(device="cpu")


def assert_reports_equal(rj, rt):
    """``ExecutionReport``s field by field, except ``wall_seconds``."""
    for name, a in vars(rj).items():
        b = getattr(rt, name)
        if name == "wall_seconds":
            continue
        if name == "actual_tau":
            np.testing.assert_array_equal(a.tau, b.tau)
        elif name == "cost":
            assert vars(a) == vars(b)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, f"{name}: {a} != {b}"
    assert list(rj.asdict()) == list(rt.asdict())


def _carry(pj):
    g = pj.graph
    return partitioned_graph_from_numpy(
        g.n_vertices, g.src, g.dst, g.weights, pj.n_parts, pj.part_of_vertex
    )


def _ragged(seed: int = 7, *, with_weights: bool = False):
    """The suite's ragged case: 400 vertices over P=5 partitions."""
    g = jgen.erdos_renyi_graph(400, 4.0, seed=seed)
    pj = jpart.bfs_grow_partition(g, 5, seed=2)
    if with_weights:
        pj = JaxPartitionedGraph(jgen.weighted(g, seed=4), pj.n_parts, pj.part_of_vertex)
    return pj, _carry(pj)


def _migrants(part, n_parts, n_migrants, k_edges, seed):
    """(src, dst) lists: each migrant gains ``k_edges`` edges (both ways)
    into one far partition -- the workload the repartitioner must fix."""
    rng = np.random.default_rng(seed)
    n = part.shape[0]
    src, dst = [], []
    for v in rng.choice(n, size=n_migrants, replace=False):
        target = (int(part[v]) + 1 + int(rng.integers(n_parts - 1))) % n_parts
        pool = np.flatnonzero(part == target)
        for u in rng.choice(pool, size=min(k_edges, pool.size), replace=False):
            src += [int(v), int(u)]
            dst += [int(u), int(v)]
    return src, dst


def _buffers(src, dst, weights=None, dels=((), ())):
    """The same staged buffer in both packages."""
    out = []
    for mod in (jdeltas, tdeltas):
        buf = mod.EdgeDeltaBuffer()
        buf.insert_many(src, dst, weights)
        if len(dels[0]):
            buf.delete_many(*dels)
        out.append(buf)
    return out


def _assert_graphs_equal(gj, gt):
    for name in ("src", "dst"):
        np.testing.assert_array_equal(getattr(gj.graph, name), getattr(gt.graph, name))
    if gj.graph.weights is None:
        assert gt.graph.weights is None
    else:
        np.testing.assert_array_equal(gj.graph.weights, gt.graph.weights)
    np.testing.assert_array_equal(gj.part_of_vertex, gt.part_of_vertex)
    assert gj.__dict__.get("_delta_generation", 0) == gt.__dict__.get("_delta_generation", 0)


# -- buffers and the merged edge list -------------------------------------------


def test_buffer_validation_and_capacity():
    pj, pt = _ragged()
    n = pt.graph.n_vertices
    buf = tdeltas.EdgeDeltaBuffer(capacity=2)
    buf.insert(0, 1)
    buf.delete(int(pt.graph.src[0]), int(pt.graph.dst[0]))
    assert (len(buf), buf.n_inserts, buf.n_deletes, buf.has_deletes) == (2, 1, 1, True)
    with pytest.raises(tdeltas.DeltaBufferFull):
        buf.insert(2, 3)
    with pytest.raises(tdeltas.DeltaBufferFull):
        tdeltas.EdgeDeltaBuffer(capacity=1).insert_many([0, 1], [1, 0])
    buf.clear()
    assert len(buf) == 0

    key = pt.graph.src.astype(np.int64) * n + pt.graph.dst
    missing = next(k for k in range(n * n) if k not in set(key.tolist()))
    cases = {
        "outside": lambda b: b.insert(0, n),
        "absent": lambda b: b.delete(missing // n, missing % n),
        "unweighted": lambda b: b.insert(0, 1, 2.5),
    }
    for match, stage in cases.items():
        for mod, pg in ((jdeltas, pj), (tdeltas, pt)):
            b = mod.EdgeDeltaBuffer()
            stage(b)
            with pytest.raises(ValueError, match=match):
                mod.apply_delta_buffer(pg, b)
    assert tdeltas.apply_delta_buffer(pt, tdeltas.EdgeDeltaBuffer()) is pt


@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_delta_buffer_matches(seed, weighted):
    rng = np.random.default_rng(seed)
    g = jgen.rmat_graph(8, 4, seed=seed)
    if weighted:
        g = jgen.weighted(g, seed=seed)
    pj = jpart.bfs_grow_partition(g, 5, seed=1)
    pt = _carry(pj)
    n = g.n_vertices
    k = int(rng.integers(1, 24))
    ins = (rng.integers(n, size=k), rng.integers(n, size=k))
    w = rng.uniform(0.1, 2.0, size=k) if weighted else None
    key = g.src.astype(np.int64) * n + g.dst
    take = rng.choice(np.unique(key), size=int(rng.integers(0, 6)), replace=False)
    bj, bt = _buffers(*ins, w, dels=(take // n, take % n))
    gj, gt = jdeltas.apply_delta_buffer(pj, bj), tdeltas.apply_delta_buffer(pt, bt)
    _assert_graphs_equal(gj, gt)
    assert gt.__dict__["_delta_generation"] == 1
    gj2, gt2 = (mod.apply_delta_buffer(g_, b) for mod, g_, b in
                zip((jdeltas, tdeltas), (gj, gt), _buffers(*ins, w)))
    _assert_graphs_equal(gj2, gt2)
    assert gt2.__dict__["_delta_generation"] == 2
    assert "_traversal_engines" not in gt.__dict__, "a merged graph starts with empty caches"


def test_reactivate_sources_leaves_the_callers_frontier_alone():
    _, pt = _ragged()
    eng = get_engine(pt, config=CPU)
    state = eng.run_window(eng.init_state([0]), 2).state
    before = state.frontier.clone()
    out = tdeltas.reactivate_sources(
        state, None, np.array([0, 0, 5]), identity=eng.program.identity
    )
    assert torch.equal(state.frontier, before)
    assert out.frontier is not state.frontier and out.dist is state.dist
    hot = before.clone()
    for v in (0, 5):
        hot[0, v] |= bool(state.dist[0, v] != np.inf)
    assert torch.equal(out.frontier, hot)
    assert tdeltas.carry_state(None, None, state) is state
    assert tdeltas.reactivate_sources(state, None, np.array([], np.int64),
                                      identity=eng.program.identity) is state


# -- the bounded repartitioner --------------------------------------------------


@pytest.mark.parametrize("mirror_degree", [None, 2])
def test_repartition_passes_match(mirror_degree):
    pj, pt = _ragged()
    bj, bt = _buffers(*_migrants(pj.part_of_vertex, 5, 12, 10, seed=3))
    cur = [jdeltas.apply_delta_buffer(pj, bj), tdeltas.apply_delta_buffer(pt, bt)]
    penalties = [trep.partition_penalty(cur[1].graph, cur[1].part_of_vertex,
                                        mirror_degree=mirror_degree)]
    for _ in range(20):
        reps = [
            mod.incremental_repartition(
                g, config=mod.RepartitionConfig(max_moves=32, balance=1.25,
                                                mirror_degree=mirror_degree)
            )
            for mod, g in zip((jrep, trep), cur)
        ]
        rj, rt = reps
        assert (rj.moves, rj.penalty_before, rj.penalty_after) == (
            rt.moves, rt.penalty_before, rt.penalty_after
        )
        for name in ("part_sizes", "part_edges", "part_activity"):
            np.testing.assert_array_equal(getattr(rj, name), getattr(rt, name))
        _assert_graphs_equal(rj.pg, rt.pg)
        assert rt.penalty_after <= rt.penalty_before
        penalties.append(rt.penalty_after)
        cur = [rj.pg, rt.pg]
        if rt.moves == 0:
            break
    assert rt.moves == 0, "the repartitioner did not converge in 20 passes"
    assert penalties == sorted(penalties, reverse=True) and penalties[-1] < penalties[0]
    assert penalties[0] == jrep.partition_penalty(
        jdeltas.apply_delta_buffer(pj, bj).graph, pj.part_of_vertex,
        mirror_degree=mirror_degree,
    )


# -- session merges: exact carry to the mutated fixpoint ------------------------


def test_session_merge_reaches_mutated_fixpoint_like_jax():
    pj, pt = _ragged(with_weights=True)
    n = pt.graph.n_vertices
    rng = np.random.default_rng(5)
    vs = rng.choice(n, size=10, replace=False)
    bj, bt = _buffers(vs, (vs + n // 2) % n, np.full(10, 0.25))

    finals = []
    for sess_mod, buf, cfg in (
        (jsession, bj, JaxConfig(m_max=64)),
        (None, bt, CPU.replace(m_max=64)),
    ):
        sess = (sess_mod.open_session if sess_mod else open_session)(
            pj if sess_mod else pt, cfg
        )
        w = sess.run_window(sess.init_state([0, 17]), 3)
        pre = np.asarray(sess.gather_global(w.state.dist))
        state = sess.apply_deltas(buf, state=w.state)
        np.testing.assert_array_equal(np.asarray(sess.gather_global(state.dist)), pre)
        for _ in range(64):
            w = sess.run_window(state, 4)
            state = w.state
            if np.asarray(w.done).all():
                break
        fresh = sess.run(sources=[0, 17])
        final = np.asarray(sess.gather_global(state.dist))
        np.testing.assert_array_equal(final, np.asarray(fresh.dist))
        finals.append(final)
    np.testing.assert_array_equal(finals[0], finals[1])
    base = get_engine(pt, config=CPU.replace(m_max=64)).run([0, 17])
    assert not np.array_equal(finals[1], base.dist), "the inserts changed nothing"


def test_session_merge_guards():
    pj, pt = _ragged()
    sess = open_session(pt, CPU.replace(m_max=64))
    state = sess.run_window(sess.init_state([0]), 2).state
    dbuf = tdeltas.EdgeDeltaBuffer()
    dbuf.delete(int(pt.graph.src[0]), int(pt.graph.dst[0]))
    with pytest.raises(ValueError, match="delete"):
        sess.apply_deltas(dbuf, state=state)
    assert sess.pg is pt, "a failed merge must not swap the session graph"
    sbuf = tdeltas.EdgeDeltaBuffer()
    sbuf.insert(0, 1)
    pr = PageRankProgram(num_iters=4)
    with pytest.raises(ValueError, match="stationary"):
        sess.apply_deltas(sbuf, state=sess.init_state([0], program=pr), program=pr)
    assert sess.apply_deltas(dbuf) is None
    assert sess.pg is not pt and sess.pg.graph.n_edges < pt.graph.n_edges

    jsess = jsession.open_session(pj, JaxConfig(m_max=64))
    jbuf = jdeltas.EdgeDeltaBuffer()
    jbuf.delete(int(pj.graph.src[0]), int(pj.graph.dst[0]))
    jsess.apply_deltas(jbuf)
    _assert_graphs_equal(jsess.pg, sess.pg)
    cfg = trep.RepartitionConfig(max_moves=16, balance=1.25)
    rt = sess.repartition(cfg)
    rj = jsess.repartition(jrep.RepartitionConfig(max_moves=16, balance=1.25))
    assert rt.moves == rj.moves and sess.pg is rt.pg and sess.last_repartition is rt
    _assert_graphs_equal(jsess.pg, sess.pg)


# -- executor and service with mutations ----------------------------------------


@pytest.mark.parametrize("repartition", [False, True], ids=["frozen-map", "repartition"])
def test_executor_mutations_match(repartition):
    pj, pt = _ragged()
    ins = _migrants(pj.part_of_vertex, 5, 8, 8, seed=9)
    bj, bt = _buffers(*ins)
    _, trj = jbsp.run_sssp(pj, 0, collect_subgraphs=False)
    _, trt = tbsp.run_sssp(pt, 0, collect_subgraphs=False, config=CPU)
    plan_j = jplace.ffd_placement(JaxTimeFunction.from_trace(trj))
    plan_t = tplace.ffd_placement(TimeFunction.from_trace(trt))
    rcfg = (
        (jrep.RepartitionConfig(max_moves=32, balance=1.25),
         trep.RepartitionConfig(max_moves=32, balance=1.25))
        if repartition else (None, None)
    )
    ex_j = jsession.open_session(pj, JaxConfig(window=1)).executor()
    rj = ex_j.run(0, plan_j, mutations=[(1, bj)], repartition=rcfg[0])
    ex_t = open_session(pt, CPU.replace(window=1)).executor()
    rt = ex_t.run(0, plan_t, mutations=[(1, bt)], repartition=rcfg[1])
    assert_reports_equal(rj, rt)
    assert rt.mutations_applied == 1 and ex_t.pg is not pt
    assert (rt.repartition_moves > 0) == repartition
    _assert_graphs_equal(ex_j.pg, ex_t.pg)
    fresh = get_engine(ex_t.pg, config=CPU.replace(m_max=256)).run([0])
    np.testing.assert_array_equal(rt.dist, fresh.dist[0])
    d = rt.asdict()
    assert d["kind"] == "execution_report" and d["mutations_applied"] == 1


def test_executor_mutation_guards():
    _, pt = _ragged()
    ex = open_session(pt, CPU).executor()
    plan = tplace.ffd_placement(TimeFunction(np.ones((3, pt.n_parts))))
    dbuf = tdeltas.EdgeDeltaBuffer()
    dbuf.delete(int(pt.graph.src[0]), int(pt.graph.dst[0]))
    with pytest.raises(ValueError, match="insert-only"):
        ex.run(0, plan, mutations=[(0, dbuf)])
    ibuf = tdeltas.EdgeDeltaBuffer()
    ibuf.insert(0, 1)
    pr_ex = open_session(pt, CPU).executor(program=PageRankProgram(num_iters=3))
    with pytest.raises(ValueError, match="monotone"):
        pr_ex.run(0, plan, mutations=[(0, ibuf)])


def test_service_mutations_match():
    pj, pt = _ragged()
    ins = _migrants(pj.part_of_vertex, 5, 6, 6, seed=11)
    reps, svcs = [], []
    for serve, deltas, pg, ecfg in ((jserve, jdeltas, pj, JaxConfig()),
                                    (tserve, tdeltas, pt, CPU)):
        trace = serve.poisson_trace(30, 10.0, pg.graph.n_vertices, seed=0)
        buf = deltas.EdgeDeltaBuffer()
        buf.insert_many(*ins)
        svc = serve.TraversalService(
            pg, config=serve.ServiceConfig(s_batch=4, window=8, tau_scale=1e3),
            engine_config=ecfg,
        )
        reps.append(svc.run(trace, mutations=[(trace[15][0], buf)]))
        svcs.append(svc)
    assert reps[0].asdict() == reps[1].asdict()
    assert reps[1].mutations_applied == 1 and reps[1].completed == 30
    assert svcs[1].pg is not pt and svcs[1].pg.graph.n_edges > pt.graph.n_edges
    _assert_graphs_equal(svcs[0].pg, svcs[1].pg)

    dbuf = tdeltas.EdgeDeltaBuffer()
    dbuf.delete(int(pt.graph.src[0]), int(pt.graph.dst[0]))
    svc = tserve.TraversalService(
        pt, config=tserve.ServiceConfig(s_batch=4, window=1, tau_scale=1e3), engine_config=CPU
    )
    trace = tserve.poisson_trace(4, 10.0, pt.graph.n_vertices, seed=0)
    with pytest.raises(ValueError, match="in flight"):  # one window after the first arrival
        svc.run(trace, mutations=[(trace[0][0] + 1e-9, dbuf)])
