"""Port parity, host layout layer: generators, partitioners, the
partition-aware edge layout, block maps and subgraph labels of
``repro_torch`` are byte-identical to the JAX package's.

Both packages get the same seeds; graphs built by the JAX package reach the
port through ``repro_torch.convert`` (numpy arrays only).
"""

import numpy as np
import pytest

import repro.graph.generators as jgen
import repro.graph.partition as jpart
import repro_torch.graph.generators as tgen
import repro_torch.graph.partition as tpart
from repro_torch.convert import partitioned_graph_from_numpy

GRAPHS = {
    "rmat9": lambda gen: gen.rmat_graph(9, 8, seed=3),
    "road16": lambda gen: gen.road_grid_graph(16, 16, seed=5),
    "er": lambda gen: gen.erdos_renyi_graph(200, 4.0, seed=7),
    "rmat9-weighted": lambda gen: gen.weighted(gen.rmat_graph(9, 8, seed=3), seed=2),
}
PARTITIONERS = {
    "bfs_grow": lambda part, g: part.bfs_grow_partition(g, 5, seed=1),
    "hash": lambda part, g: part.hash_partition(g, 5, seed=3),
}


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _graph_pair(name):
    return GRAPHS[name](jgen), GRAPHS[name](tgen)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_byte_identical(name):
    gj, gt = _graph_pair(name)
    assert gj.n_vertices == gt.n_vertices
    _assert_same(gj.src, gt.src, "src")
    _assert_same(gj.dst, gt.dst, "dst")
    assert (gj.weights is None) == (gt.weights is None)
    _assert_same(gj.edge_weights, gt.edge_weights, "edge_weights")
    _assert_same(gj.out_degree, gt.out_degree, "out_degree")
    for a, b in zip(gj.csr, gt.csr):
        _assert_same(a, b, "csr")


@pytest.mark.parametrize("pname", sorted(PARTITIONERS))
@pytest.mark.parametrize("name", ["rmat9", "road16"])
def test_partitioners_byte_identical(name, pname):
    gj, gt = _graph_pair(name)
    pj = PARTITIONERS[pname](jpart, gj)
    pt = PARTITIONERS[pname](tpart, gt)
    assert pj.n_parts == pt.n_parts
    _assert_same(pj.part_of_vertex, pt.part_of_vertex, "part_of_vertex")
    _assert_same(pj.subgraph_of_vertex, pt.subgraph_of_vertex, "subgraph_of_vertex")
    _assert_same(pj.part_of_subgraph, pt.part_of_subgraph, "part_of_subgraph")
    for a, b in zip(pj.subgraph_sizes, pt.subgraph_sizes):
        _assert_same(a, b, "subgraph_sizes")
    for a, b in zip(pj.partition_sizes, pt.partition_sizes):
        _assert_same(a, b, "partition_sizes")
    _assert_same(pj.partition_bytes(), pt.partition_bytes(), "partition_bytes")
    assert pj.edge_cut_fraction == pt.edge_cut_fraction
    assert pj.balance_factor() == pt.balance_factor()


def _converted(name, pname):
    gj = GRAPHS[name](jgen)
    pj = PARTITIONERS[pname](jpart, gj)
    pt = partitioned_graph_from_numpy(
        gj.n_vertices, gj.src, gj.dst, gj.weights, pj.n_parts, pj.part_of_vertex
    )
    return pj, pt


@pytest.mark.parametrize("pname", sorted(PARTITIONERS))
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partitioned_edge_layout_byte_identical(name, pname):
    pj, pt = _converted(name, pname)
    lj = jpart.partitioned_edge_layout(pj)
    lt = tpart.partitioned_edge_layout(pt)
    for side in ("local", "remote"):
        cj, ct = getattr(lj, side), getattr(lt, side)
        assert cj.n_vertices == ct.n_vertices
        for f in ("src", "dst", "weights", "perm"):
            _assert_same(getattr(cj, f), getattr(ct, f), f"{side}.{f}")
    for f in ("local_part", "remote_src_part", "local_eid", "remote_eid"):
        _assert_same(getattr(lj, f), getattr(lt, f), f)
    assert tpart.partitioned_edge_layout(pt) is lt  # cached on the instance


@pytest.mark.parametrize("geometry", [(8, 8), (64, 64), (512, 512), (16, 128)])
@pytest.mark.parametrize("name", ["rmat9", "road16"])
def test_block_maps_byte_identical(name, geometry):
    pj, pt = _converted(name, "bfs_grow")
    lj = jpart.partitioned_edge_layout(pj)
    lt = tpart.partitioned_edge_layout(pt)
    bn, be = geometry
    for side in ("local", "remote"):
        sj, cj, tj = getattr(lj, side).block_ranges(bn, be)
        st, ct, tt = getattr(lt, side).block_ranges(bn, be)
        _assert_same(sj, st, f"{side} start")
        _assert_same(cj, ct, f"{side} count")
        assert tj == tt


def test_contiguous_device_map_identical():
    for p, d in [(8, 2), (5, 8), (40, 4), (1, 1)]:
        _assert_same(
            jpart.contiguous_device_map(p, d), tpart.contiguous_device_map(p, d),
            f"P={p} D={d}",
        )
    with pytest.raises(ValueError):
        tpart.contiguous_device_map(0, 2)


def test_convert_copies_with_container_dtypes():
    gj = jgen.rmat_graph(9, 8, seed=3)
    pj = jpart.bfs_grow_partition(gj, 5, seed=1)
    pt = partitioned_graph_from_numpy(
        gj.n_vertices, gj.src.astype(np.int64), gj.dst.astype(np.int64), None,
        5, pj.part_of_vertex.astype(np.int64),
    )
    assert pt.graph.src.dtype == np.int32 and pt.part_of_vertex.dtype == np.int32
    assert pt.graph.weights is None
    _assert_same(pj.subgraph_of_vertex, pt.subgraph_of_vertex, "subgraphs")
