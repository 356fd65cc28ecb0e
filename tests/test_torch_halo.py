"""Port parity, halo-exchange PNA: ``repro_torch.dist.halo`` against
``repro.dist.halo``, and ``models.gnn.halo_pna`` on gloo ranks against the
JAX package's dense ``pna_forward``.

  * ``build_halo_plan`` gives the reference's arrays byte for byte (dtype,
    shape and bytes) on the graphs of ``tests/test_halo.py`` and a few
    ragged ones (isolated vertices, an empty partition, no remote edge).
  * The plan invariants and the wire-bytes bound of ``tests/test_halo.py``.
  * Halo PNA on D in {2, 8} ranks (``repro_torch.dist.run_ranks`` on the
    CPU, one partition each) over the reference's 256-vertex graph, within
    ``atol=2e-4`` of dense JAX PNA (``tests/test_halo.py``'s bound) and of
    the port's own dense forward, with one ``all_to_all`` of ``P * s_max *
    d * 4`` bytes per rank a layer.

The rank target imports nothing of JAX: this module imports the JAX package
only inside the test functions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import gnn_params_from_numpy, partitioned_graph_from_numpy
from repro_torch.dist import halo, partition_mesh, run_ranks
from repro_torch.models.gnn.halo_pna import pna_forward_halo, rank_inputs

pytestmark = pytest.mark.mesh

HALO_ATOL = 2e-4
RANK_TIMEOUT = 300.0

# name: (graph made from either package's generators module, parts, partition seed)
PLAN_GRAPHS = {
    "er300-p4": (lambda gm: gm.erdos_renyi_graph(300, 5.0, seed=2), 4, 0),
    "er2000-p8": (lambda gm: gm.erdos_renyi_graph(2000, 6.0, seed=3), 8, 1),
    "er256-p8": (lambda gm: gm.erdos_renyi_graph(256, 6.0, seed=5), 8, 1),
    "er256-p2": (lambda gm: gm.erdos_renyi_graph(256, 6.0, seed=5), 2, 1),
    "rmat-p5": (lambda gm: gm.rmat_graph(9, 4, seed=4), 5, 2),
}


def _jax_plan_and_graph(name):
    from repro.dist.halo import build_halo_plan
    from repro.graph import bfs_grow_partition, generators

    build, parts, seed = PLAN_GRAPHS[name]
    pg = bfs_grow_partition(build(generators), parts, seed=seed)
    return build_halo_plan(pg), pg


def _port_pg(pg):
    g = pg.graph
    return partitioned_graph_from_numpy(g.n_vertices, g.src, g.dst, g.weights, pg.n_parts,
                                        pg.part_of_vertex)


def _assert_plans_identical(mine, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert type(a) is type(b) and a == b, f.name


@pytest.mark.parametrize("name", sorted(PLAN_GRAPHS))
def test_build_halo_plan_is_byte_identical(name):
    ref, pg = _jax_plan_and_graph(name)
    _assert_plans_identical(halo.build_halo_plan(_port_pg(pg)), ref)


@pytest.mark.parametrize("case", ["isolated-and-empty-part", "no-remote-edge", "no-edge"])
def test_build_halo_plan_ragged_cases_are_byte_identical(case):
    from repro.dist.halo import build_halo_plan as jax_build_halo_plan
    from repro.graph.structs import Graph as JaxGraph
    from repro.graph.structs import PartitionedGraph as JaxPG

    rng = np.random.default_rng(3)
    n = 40
    if case == "isolated-and-empty-part":
        src, dst = rng.integers(0, 30, 90), rng.integers(0, 30, 90)  # 30..39 isolated
        part = rng.integers(0, 3, n)  # partition 3 of 4 holds nothing
        parts = 4
    elif case == "no-remote-edge":
        part = np.repeat(np.arange(2), n // 2)
        src = rng.integers(0, 20, 50)
        dst = rng.integers(0, 20, 50)
        parts = 2
    else:
        src = dst = np.zeros(0, np.int64)
        part, parts = rng.integers(0, 3, n), 3
    src, dst, part = src.astype(np.int32), dst.astype(np.int32), part.astype(np.int32)
    ref = jax_build_halo_plan(JaxPG(JaxGraph(n, src, dst), parts, part))
    mine = halo.build_halo_plan(partitioned_graph_from_numpy(n, src, dst, None, parts, part))
    _assert_plans_identical(mine, ref)


def test_halo_plan_invariants():
    """``tests/test_halo.py``'s invariants, on the port's plan."""
    _, pg = _jax_plan_and_graph("er300-p4")
    g = pg.graph
    plan = halo.build_halo_plan(_port_pg(pg))
    assert plan.n_shards == 4
    assert int(plan.edge_mask.sum()) == g.n_edges
    assert np.unique(plan.perm).size == g.n_vertices
    assert plan.perm.max() < 4 * plan.n_local
    assert plan.send_idx.max() <= plan.n_local
    for p in range(4):
        assert (plan.send_idx[p, p] == plan.n_local).all()
    # every real edge, read back through the extended index space, is an
    # edge of the graph, and each edge appears once
    vertex_of_row = np.full(4 * plan.n_local, -1, np.int64)
    vertex_of_row[plan.perm] = np.arange(g.n_vertices)
    got = []
    for q in range(4):
        ext = np.full(plan.n_local + 4 * plan.s_max, -1, np.int64)
        ext[: plan.n_local] = vertex_of_row[q * plan.n_local:(q + 1) * plan.n_local]
        for p in range(4):
            sent = plan.send_idx[p, q]
            slots = np.flatnonzero(sent < plan.n_local)
            ext[plan.n_local + p * plan.s_max + slots] = vertex_of_row[p * plan.n_local
                                                                       + sent[slots]]
        m = plan.edge_mask[q]
        got += zip(ext[plan.edge_src_ext[q][m]].tolist(),
                   vertex_of_row[q * plan.n_local + plan.edge_dst_loc[q][m]].tolist())
    assert sorted(got) == sorted(zip(g.src.tolist(), g.dst.tolist()))


def test_halo_wire_bytes_scale_with_cut():
    """Wire rows per layer (P^2 * Smax) stay far below the full node table
    a GSPMD-style all-gather would move (N * P rows)."""
    _, pg = _jax_plan_and_graph("er2000-p8")
    plan = halo.build_halo_plan(_port_pg(pg))
    assert plan.n_shards * plan.n_shards * plan.s_max < pg.graph.n_vertices * plan.n_shards


def test_scatter_nodes_matches_jax():
    from repro.dist.halo import scatter_nodes as jax_scatter_nodes

    ref_plan, pg = _jax_plan_and_graph("er256-p8")
    plan = halo.build_halo_plan(_port_pg(pg))
    x = np.random.default_rng(0).standard_normal((256, 7)).astype(np.float32)
    a, b = halo.scatter_nodes(plan, x), jax_scatter_nodes(ref_plan, x)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- halo PNA on ranks ----------------------------------------------------------


def _pna_case(parts: int):
    """The reference's halo case: its graph, split in ``parts``, the reduced
    PNA's parameters from its key, inputs from a numpy seed; the dense JAX
    forward."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs.registry import reduced_config as jax_reduced_config
    from repro.models.gnn.pna import init_pna, pna_forward

    ref_plan, pg = _jax_plan_and_graph("er256-p8" if parts == 8 else "er256-p2")
    g = pg.graph
    jcfg = jax_reduced_config(JAX_ARCHS["pna"])
    params = init_pna(jax.random.PRNGKey(0), jcfg, 12, 5)
    x = np.random.default_rng(11).standard_normal((g.n_vertices, 12)).astype(np.float32)
    dense = np.asarray(pna_forward(params, jcfg, jnp.asarray(x), jnp.asarray(g.src),
                                   jnp.asarray(g.dst)))
    tree = jax.tree.map(np.asarray, params)
    return pg, x, tree, dense


def _halo_rank(plan, xs, tree, cfg) -> dict:
    """One rank: its block of the plan through ``pna_forward_halo``."""
    mesh = partition_mesh(plan.n_shards, device="cpu")
    model = gnn_params_from_numpy("pna", tree, cfg, device="cpu")
    before = mesh.stats.snapshot()
    with torch.no_grad():
        out = pna_forward_halo(model, mesh, **rank_inputs(plan, xs, mesh.rank, "cpu"))
    stats = mesh.stats.snapshot()
    return {"rank": mesh.rank, "out": out.numpy(),
            "calls": {k: v - before["calls"].get(k, 0) for k, v in stats["calls"].items()},
            "bytes": {k: v - before["bytes"].get(k, 0) for k, v in stats["bytes"].items()}}


@pytest.mark.parametrize("d_n", [2, 8])
def test_halo_pna_on_gloo_ranks_matches_dense_jax(d_n):
    pg, x, tree, dense = _pna_case(d_n)
    cfg = reduced_config(ARCHS["pna"])
    plan = halo.build_halo_plan(_port_pg(pg))
    assert plan.n_shards == d_n
    ranks = run_ranks(_halo_rank, d_n, device="cpu", timeout=RANK_TIMEOUT,
                      args=(plan, halo.scatter_nodes(plan, x), tree, cfg))
    assert [r["rank"] for r in ranks] == list(range(d_n))
    flat = np.concatenate([r["out"] for r in ranks]).reshape(d_n * plan.n_local, -1)
    recovered = flat[plan.perm]
    np.testing.assert_allclose(recovered, dense, atol=HALO_ATOL)
    model = gnn_params_from_numpy("pna", tree, cfg, device="cpu")
    g = pg.graph
    with torch.no_grad():
        mine = model(torch.as_tensor(x), torch.as_tensor(g.src), torch.as_tensor(g.dst))
    np.testing.assert_allclose(recovered, mine.numpy(), atol=HALO_ATOL)
    # one all-to-all a layer, of the plan's [P, s_max, d] float32 block
    for r in ranks:
        assert r["calls"] == {"all_to_all": cfg.n_layers}
        assert r["bytes"] == {"all_to_all": cfg.n_layers * d_n * plan.s_max * cfg.d_hidden * 4}


def test_halo_pna_on_one_rank_is_the_dense_forward():
    """A one-part plan on a one-rank mesh: no exchange, the dense result."""
    from repro.graph import bfs_grow_partition, erdos_renyi_graph

    g = erdos_renyi_graph(64, 5.0, seed=8)
    pg = _port_pg(bfs_grow_partition(g, 1, seed=0))
    plan = halo.build_halo_plan(pg)
    cfg = reduced_config(ARCHS["pna"])
    model = gnn_params_from_numpy("pna", _pna_case(2)[2], cfg, device="cpu")
    x = np.random.default_rng(2).standard_normal((64, 12)).astype(np.float32)
    mesh = partition_mesh(1, device="cpu")
    with torch.no_grad():
        out = pna_forward_halo(model, mesh, **rank_inputs(plan, halo.scatter_nodes(plan, x), 0,
                                                          "cpu"))
        dense = model(torch.as_tensor(x), torch.as_tensor(g.src), torch.as_tensor(g.dst))
    np.testing.assert_allclose(out.numpy()[plan.perm], dense.numpy(), atol=1e-6)
    assert mesh.stats.snapshot()["calls"] == {}
