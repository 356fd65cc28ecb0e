"""Port parity, the multi-GPU mesh engine: the port's mesh ranks (gloo on the
CPU, one process per rank through ``repro_torch.dist.run_ranks``) against
the JAX package's mesh engine (8 forced host devices) and against the
port's own dense engine.

The same cases run on both sides at D in {2, 8}: R-MAT, Erdos-Renyi and a
ragged P=5 graph; BFS, weighted SSSP, WCC and PageRank, with and without
hub mirrors; chained windows k in {1, 8}; forced mid-run relayouts; the
elastic executor under ``relayout=True`` and ``"auto"``; a ``GraphSession``
delta merge with in-flight state; and the serving loop.  The JAX side runs
in a child started on this file's ``__main__`` branch with 8 forced
devices and dumps an ``.npz``; the rank targets below import nothing of
JAX (this module imports JAX only on that branch).

Tolerance: none for BFS, SSSP and WCC state or any int32 counter
(``wire_msgs`` included) -- the parity bar of the JAX package's own
dense-vs-mesh checks.  PageRank state within rtol 1e-5 (float sums
reassociate across ranks and the port sums in float64).  Reports are
compared field by field, exactly.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.mesh

M_MAX = 64
MESH_SIZES = (2, 8)
WINDOWS = (1, 8)
MIRROR_DEGREE = 3
RANK_TIMEOUT = 300.0
STATE_FIELDS = ("dist",)
COUNTERS = ("n_supersteps", "edges_examined", "verts_processed", "msgs_sent", "inner_iters")


# -- the cases, written once over either package ------------------------------


class _Pkg:
    """One package's entry points (``repro`` or ``repro_torch``)."""

    def __init__(self, name: str):
        self.name = name
        mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
        self.gen = mod("graph.generators")
        self.part = mod("graph.partition")
        self.structs = mod("graph.structs")
        self.prog = mod("graph.program")
        self.trav = mod("graph.traversal")
        self.bsp = mod("graph.bsp")
        self.core = mod("core")
        self.elastic = mod("core.elastic")
        self.graph = mod("graph")
        self.deltas = mod("graph.deltas")
        self.serve = mod("serve")
        self.config_mod = mod("graph.config")

    def config(self, **kw):
        if self.name == "repro_torch":
            kw.setdefault("device", "cpu")
        return self.config_mod.EngineConfig(**kw)


def _graphs(pk: _Pkg) -> dict:
    rmat = pk.part.bfs_grow_partition(pk.gen.rmat_graph(9, 6, seed=3), 6, seed=1)
    p5 = pk.part.bfs_grow_partition(pk.gen.erdos_renyi_graph(400, 4.0, seed=7), 5, seed=2)
    p5w = pk.structs.PartitionedGraph(
        pk.gen.weighted(p5.graph, seed=4), p5.n_parts, p5.part_of_vertex
    )
    return {"rmat": rmat, "p5": p5, "p5w": p5w}


def _sources(pg) -> list:
    return [0, 17, pg.graph.n_vertices - 1]


def _program_cases(pk: _Pkg):
    """(case, graph, program, sources, mirror_degree)"""
    P = pk.prog
    cases = [
        ("bfs-rmat", "rmat", P.SsspProgram(), None, None),
        ("bfs-p5", "p5", P.SsspProgram(), None, None),
    ]
    for md in (None, MIRROR_DEGREE):
        tag = "" if md is None else "-mirror"
        cases += [
            (f"sssp-p5w{tag}", "p5w", P.SsspProgram(), None, md),
            (f"wcc-p5{tag}", "p5", P.WccProgram(), [0], md),
            (f"pagerank-p5{tag}", "p5", P.PageRankProgram(num_iters=12), [0], md),
        ]
    cases.append(("bfs-p5-mirror", "p5", P.BfsProgram(), None, MIRROR_DEGREE))
    return cases


def _swap_seq(d_n: int) -> list:
    rng = np.random.default_rng(11)
    return [
        np.arange(5, dtype=np.int32) % d_n,
        (np.arange(5, dtype=np.int32)[::-1] % d_n).copy(),
        rng.integers(0, d_n, size=5).astype(np.int32),
    ]


def _delta_buffer(pk: _Pkg, n: int):
    rng = np.random.default_rng(21)
    buf = pk.deltas.EdgeDeltaBuffer()
    for v in rng.choice(n, size=12, replace=False):
        u = int((int(v) + n // 2) % n)
        buf.insert(int(v), u, 0.5)
        buf.insert(u, int(v), 0.5)
    return buf


def _flat(obj, prefix: str, out: dict) -> dict:
    """Nested reports -> ``{"a/b/c": ndarray}`` (the ``.npz`` key space)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flat(v, f"{prefix}/{k}", out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        _flat({f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}, prefix, out)
    elif isinstance(obj, (list, tuple)) and obj and isinstance(obj[0], (dict, list, tuple)):
        for i, v in enumerate(obj):
            _flat(v, f"{prefix}/{i}", out)
    elif obj is None:
        out[prefix] = np.asarray("None")
    else:
        out[prefix] = np.asarray(obj)
    return out


def _chain(eng, state, k, device_of_part=None):
    chunks = []
    for i in range(M_MAX):
        kw = {} if device_of_part is None else {"device_of_part": device_of_part[i % 3]}
        w = eng.run_window(state, k, **kw)
        state = w.state
        chunks.append(w)
        if np.asarray(w.done).all():
            break
    out = {
        f: np.concatenate([np.asarray(getattr(c, f)) for c in chunks], axis=1)
        for f in ("edges_examined", "verts_processed", "msgs_sent")
    }
    out["n_supersteps"] = np.asarray(state.n_supersteps)
    torch_rows = type(eng).__module__.startswith("repro_torch")
    out["dist"] = eng.gather_global(state.dist if torch_rows else np.asarray(state.dist))
    return out


def _report(rep) -> dict:
    d = rep.asdict()
    d.pop("wall_seconds", None)
    return d


def run_cases(pk: _Pkg, d_n: int, mesh) -> dict:
    """Every case on one package at one mesh size; returns flat arrays."""
    gs = _graphs(pk)
    out: dict = {}
    for case, g, prog, srcs, md in _program_cases(pk):
        pg = gs[g]
        srcs = srcs or _sources(pg)
        eng = pk.trav.get_engine(
            pg, program=prog, config=pk.config(mesh=mesh, m_max=M_MAX, mirror_degree=md)
        )
        res = eng.run(srcs)
        for f in (*STATE_FIELDS, *COUNTERS, "wire_msgs"):
            out[f"run/{case}/{f}"] = np.asarray(getattr(res, f))
    # chained windows on the mesh engine
    eng = pk.trav.get_engine(gs["rmat"], config=pk.config(mesh=mesh, m_max=M_MAX))
    for k in WINDOWS:
        _flat(_chain(eng, eng.init_state(_sources(gs["rmat"])), k), f"window/k{k}", out)
    # forced relayouts every window (weighted SSSP, mirrored and not)
    for md in (None, MIRROR_DEGREE):
        eng = pk.trav.TraversalEngine(
            gs["p5w"], program=pk.prog.SsspProgram(),
            config=pk.config(mesh=mesh, m_max=M_MAX, mirror_degree=md),
        )
        _flat(
            _chain(eng, eng.init_state(_sources(gs["p5w"])), 2, _swap_seq(d_n)),
            f"relayout/md{md}", out,
        )
    # the elastic executor: static layout, relayout=True and "auto"
    pg = gs["rmat"]
    _, trace = pk.bsp.run_sssp(pg, 0, config=pk.config())
    plan = pk.core.ffd_placement(pk.core.TimeFunction.from_trace(trace))
    for rl in (False, True, "auto"):
        cfg = pk.config(mesh=mesh, window=1, relayout=rl)
        rep = pk.elastic.ElasticBSPExecutor(pg, config=cfg).run(0, plan)
        _flat(_report(rep), f"exec/{rl}", out)
    # a session merging a delta buffer under in-flight state
    pg = gs["p5w"]
    srcs = _sources(pg)
    sess = pk.graph.open_session(pg, pk.config(mesh=mesh, m_max=M_MAX))
    w = sess.run_window(sess.init_state(srcs), 3)
    state = w.state
    out["session/pre"] = sess.gather_global(_rows(pk, state.dist))
    state = sess.apply_deltas(_delta_buffer(pk, pg.graph.n_vertices), state=state)
    out["session/carried"] = sess.gather_global(_rows(pk, state.dist))
    out["session/carried_nst"] = np.asarray(state.n_supersteps)
    for _ in range(M_MAX):
        w = sess.run_window(state, 3)
        state = w.state
        if np.asarray(w.done).all():
            break
    out["session/continued"] = sess.gather_global(_rows(pk, state.dist))
    out["session/fresh"] = np.asarray(sess.run(sources=srcs).dist)
    # the serving loop on the mesh
    svc = pk.serve.TraversalService(
        gs["rmat"], config=pk.serve.ServiceConfig(s_batch=4, window=4, tau_scale=1e3),
        engine_config=pk.config(mesh=mesh),
    )
    _flat(svc.run(pk.serve.poisson_trace(16, 4.0, 128, seed=7)).asdict(), "serve", out)
    return out


def _rows(pk: _Pkg, t):
    return t if pk.name == "repro_torch" else np.asarray(t)


# -- rank targets (import no JAX) ----------------------------------------------


def _rank_cases(d_n: int) -> dict:
    from repro_torch.dist import partition_mesh

    mesh = partition_mesh(d_n)
    out = run_cases(_Pkg("repro_torch"), d_n, mesh)
    eng = _Pkg("repro_torch").trav.get_engine(
        _graphs(_Pkg("repro_torch"))["p5"],
        program=_Pkg("repro_torch").prog.WccProgram(),
        config=_Pkg("repro_torch").config(mesh=mesh, m_max=M_MAX, mirror_degree=MIRROR_DEGREE),
    )
    eng.run([0])
    prog = eng._mesh_prog
    out["collectives/signature"] = prog.signature
    out["collectives/record"] = prog.last_window_collectives
    out["collectives/stats"] = mesh.stats.snapshot()["calls"]
    out["mesh/describe"] = mesh.describe()
    return out


def _rank_bad_signature() -> str:
    """A monotone program whose declared signature promises one boundary
    sync more than the engine runs: its first window must refuse it."""
    from repro_torch.dist import partition_mesh
    from repro_torch.graph.program import SsspProgram
    from repro_torch.graph.traversal import TraversalEngine

    class Liar(SsspProgram):
        name = "liar"

        def collective_signature(self, *, mirrored=False):
            sig = super().collective_signature(mirrored=mirrored)
            return dict(sig, pmax_boundary=sig["pmax_boundary"] + 1)

    pk = _Pkg("repro_torch")
    eng = TraversalEngine(
        _graphs(pk)["p5"], program=Liar(),
        config=pk.config(mesh=partition_mesh(), m_max=M_MAX),
    )
    try:
        eng.run([0])
    except RuntimeError as e:
        return str(e)
    return ""


def _rank_refusals() -> list:
    """What a mesh rank refuses: the metagraph pass's subgraph bits (dense
    only) and a rank whose config asks for another kind of device."""
    from repro_torch.dist import partition_mesh
    from repro_torch.graph.traversal import TraversalEngine

    pk = _Pkg("repro_torch")
    out = []
    for kw in ({"collect_subgraphs": True}, {"device": "cuda"}):
        try:
            TraversalEngine(_graphs(pk)["p5"], config=pk.config(mesh=partition_mesh(), **kw))
            out.append("")
        except (NotImplementedError, ValueError) as e:
            out.append(type(e).__name__ + ": " + str(e))
    return out


def _rank_default_device() -> dict:
    """``partition_mesh`` in a process group that ``run_ranks`` did not give
    a device (its rank device cleared): without CUDA it refuses rather than
    pick the CPU, and an explicit CPU mesh carries the real process group."""
    import torch.distributed as dist

    from repro_torch.dist import partition_mesh, sharding

    sharding._RANK_DEVICE = None
    try:
        partition_mesh()
        refusal = ""
    except RuntimeError as e:
        refusal = str(e)
    mesh = partition_mesh(device="cpu")
    return {
        "refusal": refusal, "device": str(mesh.device),
        "group_is_world": mesh.group is dist.group.WORLD,
        "sum": mesh.all_reduce(__import__("torch").ones(1), "sum").item(),
    }


def _rank_raise_on_one() -> None:
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()  # rank 0 waits for a peer that never comes


def _rank_sleep() -> None:
    import time

    time.sleep(60)


# -- fixtures -----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    """The JAX side's child, started in a thread at once so it runs while
    the port's ranks do; ``jax_ref`` waits for its dump."""
    from concurrent.futures import ThreadPoolExecutor

    from repro.testing.forced_devices import run_forced_devices

    path = str(tmp_path_factory.mktemp("jax-mesh") / "jax_mesh.npz")
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(
            run_forced_devices, os.path.abspath(__file__), path, n_devices=8, timeout=600
        )
        yield future, path


@pytest.fixture(scope="module")
def port(jax_child):
    from repro_torch.dist import run_ranks

    out = {}
    for d_n in MESH_SIZES:
        res = run_ranks(_rank_cases, d_n, device="cpu", timeout=RANK_TIMEOUT, args=(d_n,))
        assert res.backend == "gloo" and res.devices == ["cpu"] * d_n
        out[d_n] = res
    return out


@pytest.fixture(scope="module")
def jax_ref(jax_child):
    future, path = jax_child
    future.result()
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def dense():
    from repro_torch.dist import partition_mesh

    pk = _Pkg("repro_torch")
    gs = _graphs(pk)
    out = {}
    for case, g, prog, srcs, _ in _program_cases(pk):
        pg = gs[g]
        res = pk.trav.get_engine(
            pg, program=prog,
            config=pk.config(mesh=partition_mesh(1, device="cpu"), m_max=M_MAX),
        ).run(srcs or _sources(pg))
        out[case] = res
    return out


def _same(a, b, key, rtol=None):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{key}: shape {a.shape} != {b.shape}"
    if rtol is not None:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-9, err_msg=key)
        return
    if a.dtype.kind in "iufb":
        assert a.dtype == b.dtype, f"{key}: {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=key)


def _rtol_for(key: str):
    """PageRank state (float sums) to rounding; everything else exact."""
    if "pagerank" in key and key.endswith("/dist"):
        return 1e-5
    return None


GROUPS = ("run", "window", "relayout", "exec", "session", "serve")


# -- against the JAX package's mesh engine --------------------------------------


@pytest.mark.parametrize("d_n", MESH_SIZES)
@pytest.mark.parametrize("group", GROUPS)
def test_mesh_matches_jax_mesh_engine(port, jax_ref, d_n, group):
    ours = {k: v for k, v in port[d_n][0].items() if k.split("/")[0] == group}
    theirs = {
        k.split("/", 1)[1]: v for k, v in jax_ref.items()
        if k.startswith(f"D{d_n}/{group}/")
    }
    assert ours, group
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        _same(ours[key], theirs[key], f"D={d_n} {key}", rtol=_rtol_for(key))


@pytest.mark.parametrize("d_n", MESH_SIZES)
def test_every_rank_returns_the_same_results(port, d_n):
    first = port[d_n][0]
    for r, other in enumerate(port[d_n][1:], start=1):
        for key, v in first.items():
            if key.startswith(("collectives/", "mesh/")):
                continue
            np.testing.assert_array_equal(other[key], v, err_msg=f"rank {r} {key}")


# -- against the port's dense engine ---------------------------------------------


@pytest.mark.parametrize("d_n", MESH_SIZES)
@pytest.mark.parametrize(
    "case", [c[0] for c in _program_cases(_Pkg("repro_torch"))]
)
def test_mesh_matches_dense_engine(port, dense, d_n, case):
    ours = port[d_n][0]
    ref = dense[case]
    for f in (*STATE_FIELDS, *COUNTERS):
        key = f"run/{case}/{f}"
        _same(ours[key], getattr(ref, f), f"D={d_n} {key}", rtol=_rtol_for(key))
    wire = int(ours[f"run/{case}/wire_msgs"].sum())
    assert 0 < wire < int(ref.msgs_sent.sum()), (case, wire)
    assert int(ref.wire_msgs.sum()) == 0


@pytest.mark.parametrize("d_n", MESH_SIZES)
def test_mirrors_shrink_the_wire_and_change_nothing_else(port, d_n):
    ours = port[d_n][0]
    for prog in ("sssp-p5w", "wcc-p5", "pagerank-p5"):
        plain = ours[f"run/{prog}/wire_msgs"].sum()
        mirrored = ours[f"run/{prog}-mirror/wire_msgs"].sum()
        if prog.startswith("pagerank"):
            assert mirrored == plain
        else:
            assert 0 < mirrored < plain, (prog, mirrored, plain)
        for f in COUNTERS:
            np.testing.assert_array_equal(
                ours[f"run/{prog}-mirror/{f}"], ours[f"run/{prog}/{f}"]
            )


# -- the executor's physical ledger and residency ---------------------------------


@pytest.mark.parametrize("d_n", MESH_SIZES)
def test_executor_relayout_follows_the_plan(port, d_n):
    ours = port[d_n][0]
    static, moved, auto = "exec/False", "exec/True", "exec/auto"
    for f in ("dist", "actual_tau/tau", "n_migrations", "migration_bytes", "cost/migration_secs",
              "cost/cost_quanta", "cost/makespan"):
        np.testing.assert_array_equal(ours[f"{moved}/{f}"], ours[f"{static}/{f}"])
        np.testing.assert_array_equal(ours[f"{auto}/{f}"], ours[f"{static}/{f}"])
    assert ours[f"{moved}/relayouts"] > 0 and ours[f"{moved}/relayouts_skipped"] == 0
    assert ours[f"{moved}/device_moves"] > 0
    assert ours[f"{auto}/relayouts"] <= ours[f"{moved}/relayouts"]
    assert ours[f"{static}/relayouts"] == 0


# -- the session's carry ------------------------------------------------------------


@pytest.mark.parametrize("d_n", MESH_SIZES)
def test_session_delta_merge_carries_state_exactly(port, d_n):
    ours = port[d_n][0]
    np.testing.assert_array_equal(ours["session/carried"], ours["session/pre"])
    np.testing.assert_array_equal(ours["session/continued"], ours["session/fresh"])
    assert not np.array_equal(ours["session/fresh"], ours["run/bfs-p5/dist"])


# -- collectives against the declared signature ---------------------------------------


@pytest.mark.parametrize("d_n", MESH_SIZES)
def test_collectives_per_superstep_equal_the_signature(port, d_n):
    from repro_torch.graph.program import WccProgram, validate_collective_signature

    for res in port[d_n]:
        sig = validate_collective_signature(WccProgram(), mirrored=True)
        assert res["collectives/signature"] == sig
        record = res["collectives/record"]
        assert record, "the window recorded no superstep"
        for step in record:
            iters = step.pop("closure_iters")
            assert iters >= 1
            assert step == dict(sig, pmax_closure=sig["pmax_closure"] * iters)
        assert res["collectives/stats"]["all_to_all"] > 0
        assert res["mesh/describe"]["transport"] == "direct"


def test_a_window_off_its_signature_raises():
    from repro_torch.dist import run_ranks

    msgs = run_ranks(_rank_bad_signature, 2, device="cpu", timeout=RANK_TIMEOUT)
    assert all("differ from the signature" in m for m in msgs), msgs


def test_mesh_ranks_refuse_subgraph_bits_and_a_foreign_device():
    from repro_torch.dist import run_ranks

    for subgraphs, device in run_ranks(_rank_refusals, 2, device="cpu", timeout=RANK_TIMEOUT):
        assert subgraphs.startswith("NotImplementedError") and "dense" in subgraphs
        assert device.startswith("ValueError") and "runs on cpu" in device


def test_cuda_ranks_refuse_a_machine_without_cuda():
    import torch

    from repro_torch.dist import plan_ranks, run_ranks

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot show here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(_rank_sleep, 2, device="cuda")
    assert plan_ranks(3, "cpu") == ("gloo", ["cpu"] * 3)


def test_a_rank_without_a_given_device_refuses_to_pick_the_cpu():
    import torch

    from repro_torch.dist import run_ranks

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is the card")
    for res in run_ranks(_rank_default_device, 2, device="cpu", timeout=RANK_TIMEOUT):
        assert "CUDA is not available" in res["refusal"]
        assert res["device"] == "cpu" and res["group_is_world"] and res["sum"] == 2.0


# -- the launcher's failure paths ----------------------------------------------------


def test_a_failed_rank_fails_the_launch():
    from repro_torch.dist import RankFailed, run_ranks

    with pytest.raises(RankFailed, match="rank 1 fails on purpose"):
        run_ranks(_rank_raise_on_one, 2, device="cpu", timeout=RANK_TIMEOUT)


def test_a_late_launch_is_killed():
    from repro_torch.dist import RankFailed, run_ranks

    with pytest.raises(RankFailed, match="deadline"):
        run_ranks(_rank_sleep, 2, device="cpu", timeout=5)


def test_one_rank_mesh_takes_the_dense_path():
    from repro_torch.dist import partition_mesh
    from repro_torch.graph.traversal import TraversalEngine

    pk = _Pkg("repro_torch")
    eng = TraversalEngine(
        _graphs(pk)["p5"], config=pk.config(mesh=partition_mesh(1, device="cpu"))
    )
    assert eng._mesh_prog is None and eng.device_of_part is None
    with pytest.raises(ValueError, match="run_ranks"):
        partition_mesh(2, device="cpu")


# -- the JAX side (a forced-8-device child) ---------------------------------------------


def _jax_main(out_path: str) -> None:
    import jax

    assert len(jax.devices()) == 8, jax.devices()
    from repro.dist.sharding import partition_mesh

    pk = _Pkg("repro")
    dump = {}
    for d_n in MESH_SIZES:
        for k, v in run_cases(pk, d_n, partition_mesh(d_n)).items():
            dump[f"D{d_n}/{k}"] = v
    np.savez(out_path, **dump)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
