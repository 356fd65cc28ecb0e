"""Port parity, the mesh layout: ``repro_torch``'s ``mesh_edge_layout`` --
plain, mirrored, rebuilt incrementally, and merged after an edge delta --
is byte-identical to the JAX package's, field by field (pads, validity
masks and ``layout_key`` included); ``relayout_rows`` / ``relayout_state``
round-trip exactly.  Pure numpy on both sides: the JAX package's layout
builder is host code, so this file needs no devices.

The cases follow ``tests/test_mesh_traversal.py``: ragged ``(P, D)`` in
{(5, 2), (5, 8), (6, 3), (8, 4)}, with and without hub mirrors.
"""

import dataclasses

import numpy as np
import pytest

import repro.graph.deltas as jdeltas
import repro.graph.generators as jgen
import repro.graph.partition as jpart
import repro.graph.structs as jstructs
import repro_torch.graph.deltas as tdeltas
import repro_torch.graph.generators as tgen
import repro_torch.graph.partition as tpart
import repro_torch.graph.structs as tstructs
from repro.graph.mesh_exchange import plane_shards as jplane_shards
from repro.graph.program import PageRankProgram as JPageRank
from repro_torch.graph.mesh_exchange import plane_shards, relayout_rows, relayout_state
from repro_torch.graph.program import PageRankProgram
from repro_torch.graph.traversal import WindowState

RAGGED = [(5, 2), (5, 8), (6, 3), (8, 4)]
MIRRORS = [None, 3]


def _pair(n_parts, n=300, seed=11):
    def build(gen, part):
        return part.bfs_grow_partition(gen.erdos_renyi_graph(n, 4.0, seed=seed), n_parts, seed=2)

    return build(jgen, jpart), build(tgen, tpart)


def _fresh(pg, structs):
    """Same graph and partition, no instance caches (a from-scratch build)."""
    return structs.PartitionedGraph(pg.graph, pg.n_parts, pg.part_of_vertex)


def _assert_layouts_equal(lj, lt):
    assert [f.name for f in dataclasses.fields(lj)] == [
        f.name for f in dataclasses.fields(lt)
    ]
    for f in dataclasses.fields(lj):
        a, b = getattr(lj, f.name), getattr(lt, f.name)
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray), f.name
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)
    assert lj.layout_key == lt.layout_key
    assert lj.state_width == lt.state_width


@pytest.mark.parametrize("mirror", MIRRORS)
@pytest.mark.parametrize("n_parts,n_dev", RAGGED)
def test_mesh_layout_byte_identical(n_parts, n_dev, mirror):
    pj, pt = _pair(n_parts)
    dmap = jpart.contiguous_device_map(n_parts, n_dev)
    np.testing.assert_array_equal(dmap, tpart.contiguous_device_map(n_parts, n_dev))
    lj = jpart.mesh_edge_layout(pj, dmap, n_dev, mirror_degree=mirror)
    lt = tpart.mesh_edge_layout(pt, dmap, n_dev, mirror_degree=mirror)
    _assert_layouts_equal(lj, lt)
    if mirror is not None:
        assert lt.m_pad > 0, "the threshold must select hubs"
    # the layout's own state indexing agrees too
    rows = np.arange(lt.state_width * 2, dtype=np.float32).reshape(2, -1)
    np.testing.assert_array_equal(lj.gather_global(rows), lt.gather_global(rows))


@pytest.mark.parametrize("mirror", MIRRORS)
@pytest.mark.parametrize("n_parts,n_dev", [(5, 2), (5, 8), (8, 4)])
def test_incremental_rebuild_byte_identical(n_parts, n_dev, mirror):
    """Random map edits rebuilt incrementally (each side from its own base)
    equal the JAX package's and the port's own from-scratch builds."""
    pj, pt = _pair(n_parts, n=350, seed=9)
    rng = np.random.default_rng(4)
    base = tpart.contiguous_device_map(n_parts, n_dev)
    jpart.mesh_edge_layout(pj, base, n_dev, mirror_degree=mirror)
    tpart.mesh_edge_layout(pt, base, n_dev, mirror_degree=mirror)
    for _ in range(8):
        m = base.copy()
        idx = rng.choice(n_parts, size=int(rng.integers(1, 3)), replace=False)
        m[idx] = rng.integers(0, n_dev, size=idx.size)
        lt = tpart.mesh_edge_layout(pt, m, n_dev, mirror_degree=mirror)
        lj = jpart.mesh_edge_layout(pj, m, n_dev, mirror_degree=mirror)
        _assert_layouts_equal(lj, lt)
        # both sides took the same path (incremental or scratch) and rebuilt
        # the same number of devices
        assert lt.__dict__["_build_info"] == lj.__dict__["_build_info"]
        _assert_layouts_equal(
            tpart.mesh_edge_layout(_fresh(pt, tstructs), m, n_dev, mirror_degree=mirror), lt
        )


def _ring(structs, p=8, per=10):
    n = p * per
    src, dst = [], []
    for i in range(p):
        lo = i * per
        src += list(range(lo, lo + per - 1))
        dst += list(range(lo + 1, lo + per))
        src.append(lo + per - 1)
        dst.append(((i + 1) % p) * per)
    g = structs.Graph(n, np.array(src, np.int32), np.array(dst, np.int32))
    return structs.PartitionedGraph(g, p, np.repeat(np.arange(p, dtype=np.int32), per))


def test_incremental_rebuild_reuses_untouched_devices():
    """A pad-stable swap takes the incremental path on both sides, rebuilds
    the same devices, and yields the canonical layout."""
    pj, pt = _ring(jstructs), _ring(tstructs)
    base = tpart.contiguous_device_map(8, 8)
    for pg, part in ((pj, jpart), (pt, tpart)):
        part.mesh_edge_layout(pg, base, 8)
    m = base.copy()
    m[0], m[1] = base[1], base[0]
    lj = jpart.mesh_edge_layout(pj, m, 8)
    lt = tpart.mesh_edge_layout(pt, m, 8)
    assert lt.__dict__["_build_info"] == lj.__dict__["_build_info"]
    assert lt.__dict__["_build_info"]["incremental"]
    assert lt.__dict__["_build_info"]["devices_rebuilt"] < 8
    _assert_layouts_equal(lj, lt)


def test_layout_key_covers_dtype_shape_devices_and_generation():
    m32 = np.array([0, 1, 0], np.int32)
    for key_fn in (jstructs.mesh_layout_key, tstructs.mesh_layout_key):
        assert key_fn(m32, 2) == key_fn(m32.astype(np.int64), 2)
        assert key_fn(m32, 2) != key_fn(m32, 3)
        assert key_fn(m32, 2) != key_fn(m32, 2, generation=1)
    assert tstructs.mesh_layout_key(m32, 2, 4) == jstructs.mesh_layout_key(m32, 2, 4)


def test_mesh_layout_rejects_bad_maps():
    _, pt = _pair(5)
    with pytest.raises(ValueError, match="shape"):
        tpart.mesh_edge_layout(pt, np.zeros(4, np.int32), 2)
    with pytest.raises(ValueError, match="device ids"):
        tpart.mesh_edge_layout(pt, np.full(5, 2, np.int32), 2)
    with pytest.raises(ValueError, match="mirror_degree"):
        tpart.mesh_edge_layout(pt, np.zeros(5, np.int32), 2, mirror_degree=0)


@pytest.mark.parametrize("mirror", MIRRORS)
@pytest.mark.parametrize("n_parts,n_dev", [(5, 2), (5, 8)])
def test_plane_shards_match(n_parts, n_dev, mirror):
    """PageRank's ``1/out_degree`` plane lands in the same padded slots, and
    a rank's own rows are its slice of the full shards."""
    pj, pt = _pair(n_parts)
    dmap = tpart.contiguous_device_map(n_parts, n_dev)
    lj = jpart.mesh_edge_layout(pj, dmap, n_dev, mirror_degree=mirror)
    lt = tpart.mesh_edge_layout(pt, dmap, n_dev, mirror_degree=mirror)
    full_j = jplane_shards(pj, JPageRank(), lj)
    full_t = plane_shards(pt, PageRankProgram(), lt)
    for a, b in zip(full_j, full_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    for d in range(n_dev):
        rank_layout = tpart.mesh_rank_layout(
            _fresh(pt, tstructs), dmap, n_dev, d, mirror_degree=mirror
        )
        for a, b in zip(full_t, plane_shards(pt, PageRankProgram(), rank_layout)):
            np.testing.assert_array_equal(a[d], b)


@pytest.mark.parametrize("n_parts,n_dev", [(5, 2), (5, 8), (8, 4)])
def test_row_ptr_of_every_plane(n_parts, n_dev):
    """Each rank's CSR offsets span its plane: ``row_ptr[-1]`` is the padded
    edge count and every padded edge lands on the plane's last row."""
    _, pt = _pair(n_parts)
    lt = tpart.mesh_edge_layout(
        pt, tpart.contiguous_device_map(n_parts, n_dev), n_dev, mirror_degree=3
    )
    for d in range(n_dev):
        for kind in ("local", "wire", "mirror"):
            rows, n_seg, n_valid = lt.plane(kind, d)
            rp = lt.row_ptr(kind, d)
            assert rp.dtype == np.int32 and rp.shape == (n_seg + 1,)
            assert rp[-1] == rows.shape[0] and (np.diff(rp) >= 0).all()
            np.testing.assert_array_equal(np.repeat(np.arange(n_seg), np.diff(rp)), rows)
            if n_valid < rows.shape[0]:
                assert (rows[n_valid:] == max(0, n_seg - 1)).all()


def _random_state(layout, seed=0, s=3):
    rng = np.random.default_rng(seed)
    n = layout.n_vertices
    dist_g = rng.random((s, n)).astype(np.float32)
    fr_g = rng.random((s, n)) < 0.3
    dist = np.full((s, layout.state_width), np.inf, np.float32)
    dist[:, layout.pos_of_vertex] = dist_g
    fr = np.zeros((s, layout.state_width), bool)
    fr[:, layout.pos_of_vertex] = fr_g
    return dist_g, fr_g, WindowState(dist, fr, np.zeros(s, np.int32))


@pytest.mark.parametrize("mirror", MIRRORS)
def test_relayout_state_round_trips_exactly(mirror):
    """A -> B -> A is bit-identical, the global content survives B, B's
    padding carries the identity, and the JAX package's remap agrees."""
    from repro.graph.mesh_exchange import relayout_rows as jrelayout_rows

    pj, pt = _pair(5, seed=5)
    maps = (np.array([0, 1, 0, 1, 1], np.int32), np.array([1, 0, 0, 1, 0], np.int32))
    la, lb = (tpart.mesh_edge_layout(pt, m, 2, mirror_degree=mirror) for m in maps)
    ja, jb = (jpart.mesh_edge_layout(pj, m, 2, mirror_degree=mirror) for m in maps)
    dist_g, fr_g, state_a = _random_state(la)
    inf = np.float32(np.inf)
    state_b = relayout_state(la, lb, state_a, identity=inf)
    np.testing.assert_array_equal(lb.gather_global(state_b.dist), dist_g)
    np.testing.assert_array_equal(lb.gather_global(state_b.frontier), fr_g)
    assert np.isinf(state_b.dist[:, ~lb.pos_valid.reshape(-1)]).all()
    assert not state_b.frontier[:, ~lb.pos_valid.reshape(-1)].any()
    np.testing.assert_array_equal(
        np.asarray(jrelayout_rows(ja, jb, state_a.dist, inf)), state_b.dist
    )
    back = relayout_state(lb, la, state_b, identity=inf)
    np.testing.assert_array_equal(back.dist, state_a.dist)
    np.testing.assert_array_equal(back.frontier, state_a.frontier)
    np.testing.assert_array_equal(back.n_supersteps, state_a.n_supersteps)


def test_relayout_rows_rejects_mismatched_graphs():
    la = tpart.mesh_edge_layout(_pair(3, n=100)[1], np.array([0, 1, 0], np.int32), 2)
    lb = tpart.mesh_edge_layout(_pair(3, n=120)[1], np.array([0, 1, 0], np.int32), 2)
    with pytest.raises(ValueError, match="n_vertices"):
        relayout_rows(la, lb, np.zeros((1, la.state_width), np.float32), np.inf)


def _delta(pkg_deltas, n, seed=21):
    rng = np.random.default_rng(seed)
    buf = pkg_deltas.EdgeDeltaBuffer()
    for v in rng.choice(n, size=12, replace=False):
        u = int((int(v) + n // 2) % n)
        buf.insert(int(v), u)
        buf.insert(u, int(v))
    return buf


@pytest.mark.parametrize("mirror", MIRRORS)
@pytest.mark.parametrize("n_parts,n_dev", [(5, 2), (5, 8), (8, 4)])
def test_delta_merge_layout_byte_identical(n_parts, n_dev, mirror):
    """``delta_changed_devices`` flags the same devices on both sides, and
    ``merged_mesh_layout`` equals the JAX package's merge and a build from
    scratch of the mutated graph; the merged layout is what the new graph's
    cache serves."""
    pj, pt = _pair(n_parts, seed=9)
    dmap = tpart.contiguous_device_map(n_parts, n_dev)
    lj = jpart.mesh_edge_layout(pj, dmap, n_dev, mirror_degree=mirror)
    lt = tpart.mesh_edge_layout(pt, dmap, n_dev, mirror_degree=mirror)
    nj = jdeltas.apply_delta_buffer(pj, _delta(jdeltas, pj.graph.n_vertices))
    nt = tdeltas.apply_delta_buffer(pt, _delta(tdeltas, pt.graph.n_vertices))
    np.testing.assert_array_equal(
        jdeltas.delta_changed_devices(pj, nj, lj), tdeltas.delta_changed_devices(pt, nt, lt)
    )
    mj = jdeltas.merged_mesh_layout(pj, nj, lj)
    mt = tdeltas.merged_mesh_layout(pt, nt, lt)
    _assert_layouts_equal(mj, mt)
    assert mt.delta_generation == 1 and mt.layout_key != lt.layout_key
    fresh = tstructs.PartitionedGraph(nt.graph, nt.n_parts, nt.part_of_vertex)
    fresh.__dict__["_delta_generation"] = 1
    _assert_layouts_equal(
        mt, tpart.mesh_edge_layout(fresh, dmap, n_dev, mirror_degree=mirror)
    )
    assert tpart.mesh_edge_layout(nt, dmap, n_dev, mirror_degree=mirror) is mt


def test_merge_of_nothing_keeps_the_layout():
    _, pt = _pair(5)
    lt = tpart.mesh_edge_layout(pt, tpart.contiguous_device_map(5, 2), 2)
    assert tdeltas.merged_mesh_layout(pt, pt, lt) is lt


def test_shared_graph_round_trip(tmp_path):
    """``dist.share_graph`` / ``load_shared_graph`` hand a graph, its edge
    layout and the layout's per-partition slices over memory-mapped files:
    the loaded ones are the built ones (no rebuild), and a rank's mesh
    layout built on the mapped graph --
    from scratch, then incrementally -- is the canonical one."""
    from repro_torch.dist import load_shared_graph, share_graph
    from repro_torch.graph.partition import partitioned_edge_layout

    _, pt = _pair(5)
    dmap = tpart.contiguous_device_map(5, 2)
    pel = partitioned_edge_layout(pt)
    share_graph(pt, tmp_path)
    pg = load_shared_graph(tmp_path)
    pel2 = pg.__dict__["_edge_layout"]
    assert partitioned_edge_layout(pg) is pel2
    sl, sl2 = tpart._mesh_part_slices(pt), tpart._mesh_part_slices(pg)
    for f in dataclasses.fields(sl):
        a, b = getattr(sl, f.name), getattr(sl2, f.name)
        for x, y in zip(a, b) if isinstance(a, list) else [(a, b)]:
            np.testing.assert_array_equal(x, y, err_msg=f.name)
    for f in ("local_part", "remote_src_part", "local_eid", "remote_eid"):
        np.testing.assert_array_equal(getattr(pel, f), getattr(pel2, f))
    for side in ("local", "remote"):
        for f in ("src", "dst", "weights", "perm"):
            np.testing.assert_array_equal(
                getattr(getattr(pel, side), f), getattr(getattr(pel2, side), f)
            )
    m = np.array([1, 1, 0, 0, 1], np.int32)
    for r in range(2):
        base = tpart.mesh_rank_layout(pg, dmap, 2, r, mirror_degree=3)
        _assert_rank_layout_is_row(base, tpart.mesh_edge_layout(pt, dmap, 2, mirror_degree=3))
        _assert_rank_layout_is_row(
            tpart.mesh_rank_layout(pg, m, 2, r, base=base, mirror_degree=3),
            tpart.mesh_edge_layout(_fresh(pt, tstructs), m, 2, mirror_degree=3),
        )


# -- one rank's block (what a mesh rank builds and holds) -----------------------


def _assert_rank_layout_is_row(rl, full):
    """``rl`` is field for field rank ``rl.rank``'s block of ``full``."""
    row = tstructs.MeshRankLayout.of(full, rl.rank)
    for f in dataclasses.fields(tstructs.MeshRankLayout):
        a, b = getattr(rl, f.name), getattr(row, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), f.name
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)
    assert rl.layout_key == full.layout_key and rl.state_width == full.state_width


@pytest.mark.parametrize("mirror", MIRRORS)
@pytest.mark.parametrize("n_parts,n_dev", RAGGED)
def test_rank_layout_is_its_row_of_the_jax_layout(n_parts, n_dev, mirror):
    """Each rank's block, built alone on a graph with no caches, is its row
    of the JAX package's layout (ranks holding no partition included)."""
    pj, pt = _pair(n_parts)
    dmap = tpart.contiguous_device_map(n_parts, n_dev)
    lj = jpart.mesh_edge_layout(pj, dmap, n_dev, mirror_degree=mirror)
    lt = tpart.mesh_edge_layout(pt, dmap, n_dev, mirror_degree=mirror)
    kinds = ("local", "wire") + (("mirror",) if lt.m_pad else ())
    for r in range(n_dev):
        rl = tpart.mesh_rank_layout(_fresh(pt, tstructs), dmap, n_dev, r, mirror_degree=mirror)
        _assert_rank_layout_is_row(rl, lj)
        assert rl.__dict__["_build_info"]["rebuilt"] == ["local", "out", "recv"]
        for kind in kinds:
            assert rl.plane(kind)[1:] == lt.plane(kind, r)[1:]
            np.testing.assert_array_equal(rl.row_ptr(kind), lt.row_ptr(kind, r))
        with pytest.raises(ValueError, match="holds no plane"):
            rl.plane("wire", (r + 1) % n_dev)


@pytest.mark.parametrize("mirror", MIRRORS)
@pytest.mark.parametrize("n_parts,n_dev", [(5, 2), (5, 8), (8, 4)])
def test_rank_layout_incremental_rebuild_is_canonical(n_parts, n_dev, mirror):
    """Random map edits, each rank rebuilding from its own previous block,
    give the rows of a from-scratch build; a pad-stable edit reuses planes."""
    _, pt = _pair(n_parts, n=350, seed=9)
    rng = np.random.default_rng(4)
    dmap = tpart.contiguous_device_map(n_parts, n_dev)
    graphs = [_fresh(pt, tstructs) for _ in range(n_dev)]  # one per "rank"
    bases = [
        tpart.mesh_rank_layout(graphs[r], dmap, n_dev, r, mirror_degree=mirror)
        for r in range(n_dev)
    ]
    for _ in range(8):
        m = bases[0].device_of_part.copy()
        idx = rng.choice(n_parts, size=int(rng.integers(1, 3)), replace=False)
        m[idx] = rng.integers(0, n_dev, size=idx.size)
        full = tpart.mesh_edge_layout(_fresh(pt, tstructs), m, n_dev, mirror_degree=mirror)
        bases = [
            tpart.mesh_rank_layout(graphs[r], m, n_dev, r, base=bases[r], mirror_degree=mirror)
            for r in range(n_dev)
        ]
        for rl in bases:
            _assert_rank_layout_is_row(rl, full)


def test_rank_layout_reuses_the_planes_a_swap_leaves_alone():
    """Swapping two ring partitions between ranks 0 and 1 rebuilds their
    planes; rank 4, which neither sends into them nor holds them, reuses
    every plane (the shared arrays are the base's own)."""
    pt = _ring(tstructs)
    base_map = tpart.contiguous_device_map(8, 8)
    m = base_map.copy()
    m[0], m[1] = base_map[1], base_map[0]
    full = tpart.mesh_edge_layout(_ring(tstructs), m, 8)
    for r in range(8):
        pg = _ring(tstructs)
        base = tpart.mesh_rank_layout(pg, base_map, 8, r)
        rl = tpart.mesh_rank_layout(pg, m, 8, r, base=base)
        _assert_rank_layout_is_row(rl, full)
        info = rl.__dict__["_build_info"]
        assert info["incremental"]
        if r in (0, 1):
            assert "local" in info["rebuilt"]
        if r == 4:
            assert info["rebuilt"] == []
            assert rl.lsrc is base.lsrc and rl.recv_idx is base.recv_idx


@pytest.mark.parametrize("mirror", MIRRORS)
@pytest.mark.parametrize("n_parts,n_dev", [(5, 2), (5, 8), (8, 4)])
def test_rank_layout_delta_merge_is_its_row(n_parts, n_dev, mirror):
    """``merged_mesh_layout`` of a rank's block is its row of the JAX
    package's merged layout, and what the merged graph's cache serves."""
    pj, pt = _pair(n_parts, seed=9)
    dmap = tpart.contiguous_device_map(n_parts, n_dev)
    lj = jpart.mesh_edge_layout(pj, dmap, n_dev, mirror_degree=mirror)
    nj = jdeltas.apply_delta_buffer(pj, _delta(jdeltas, pj.graph.n_vertices))
    mj = jdeltas.merged_mesh_layout(pj, nj, lj)
    for r in range(n_dev):
        pg = _fresh(pt, tstructs)
        old = tpart.mesh_rank_layout(pg, dmap, n_dev, r, mirror_degree=mirror)
        new_pg = tdeltas.apply_delta_buffer(pg, _delta(tdeltas, pg.graph.n_vertices))
        merged = tdeltas.merged_mesh_layout(pg, new_pg, old)
        _assert_rank_layout_is_row(merged, mj)
        assert merged.delta_generation == 1
        assert tpart.mesh_rank_layout(new_pg, dmap, n_dev, r, mirror_degree=mirror) is merged


def test_rank_layout_rejects_a_foreign_rank():
    _, pt = _pair(5)
    with pytest.raises(ValueError, match="not in"):
        tpart.mesh_rank_layout(pt, tpart.contiguous_device_map(5, 2), 2, 2)
