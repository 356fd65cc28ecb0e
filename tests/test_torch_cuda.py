"""The CUDA relax kernel on the card, against its plain version.

Every test here needs an NVIDIA card with ``nvcc`` and skips with a reason
elsewhere.  The file imports neither JAX nor the JAX package, so it runs on
a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: ``min`` is bit-exact; ``sum`` is ``rtol=1e-5, atol=1e-9``
(both sum float32 in float64, in different orders).
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import partitioned_graph_from_numpy
from repro_torch.graph import bfs_grow_partition, rmat_graph, weighted
from repro_torch.graph.config import EngineConfig
from repro_torch.graph.program import BUILTIN_PROGRAMS
from repro_torch.graph.structs import dst_sorted_layout, row_ptr_for
from repro_torch.graph.traversal import TraversalEngine, reference_pagerank
from repro_torch.kernels.bfs_relax import ops
from repro_torch.kernels.bfs_relax.kernel import relax_rowptr
from repro_torch.kernels.bfs_relax.ref import relax_reference

SHAPES = {
    # name: (S, n, e)
    "ragged": (3, 257, 1023),
    "hub": (2, 16, 600),
    "e0": (3, 50, 0),
    "n_lt_8": (3, 5, 9),
    "single_edge": (3, 40, 1),
}
VARIANTS = [("min", np.float32), ("min", np.int32), ("sum", np.float32)]
VARIANT_IDS = ["min-f32", "min-i32", "sum-f32"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA card and nvcc; on the card run "
            "`PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`"
        )
    return torch.device("cuda")


def _inputs(s, n, e, reduce, dtype, seed):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    ident = ops._identity_scalar(reduce, dtype)
    if dtype == np.int32:
        cand = rng.integers(0, 1000, (s, e)).astype(np.int32)
        base = rng.integers(0, 1000, (s, n)).astype(np.int32)
    else:
        cand = rng.uniform(0.0, 10.0, (s, e)).astype(np.float32)
        base = rng.uniform(0.0, 10.0, (s, n)).astype(np.float32)
    cand[rng.random((s, e)) < 0.3] = ident
    if reduce == "min":
        base[rng.random((s, n)) < 0.3] = ident
    return dst, cand, base


def _assert_close(out, ref, reduce):
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if reduce == "min":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_kernel_matches_plain_version(cuda_device, shape, variant):
    reduce, dtype = variant
    s, n, e = SHAPES[shape]
    dst, cand, base = _inputs(s, n, e, reduce, dtype, seed=n * 13 + e)
    on = dict(device=cuda_device)
    cand_t, base_t = torch.as_tensor(cand, **on), torch.as_tensor(base, **on)
    row_ptr = torch.as_tensor(row_ptr_for(dst, n), **on)
    before = relax_rowptr.launches
    out = relax_rowptr(row_ptr, cand_t, base_t, reduce=reduce)
    ref = relax_reference(torch.as_tensor(dst.astype(np.int64), **on), cand_t, base_t, reduce)
    torch.cuda.synchronize()
    assert relax_rowptr.launches == before + 1
    _assert_close(out, ref, reduce)


@pytest.mark.cuda
@pytest.mark.parametrize("presorted", [False, True])
def test_bfs_relax_entries_on_cuda_match_torch_backend(cuda_device, presorted):
    n, e = 300, 2000
    rng = np.random.default_rng(3)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.uniform(0.5, 2.0, e).astype(np.float32)
    layout = dst_sorted_layout(n, src, dst, w)
    if presorted:
        src, dst, w = layout.src, layout.dst, layout.weights
    dist = np.where(rng.random((3, n)) < 0.5, rng.uniform(0, 10, (3, n)), np.inf)
    dist = torch.as_tensor(dist.astype(np.float32), device=cuda_device)
    frontier = torch.as_tensor(rng.random((3, n)) < 0.4, device=cuda_device)
    edges = [torch.as_tensor(a, device=cuda_device) for a in (src, dst, w)]
    for backend in ("cuda", "torch"):
        assert ops.validate_backend(backend, cuda_device) == backend
    _assert_close(
        ops.bfs_relax(dist[0], frontier[0], *edges, presorted=presorted, backend="cuda"),
        ops.bfs_relax(dist[0], frontier[0], *edges, presorted=presorted, backend="torch"),
        "min",
    )
    _assert_close(
        ops.bfs_relax_csr(dist, frontier, layout, backend="cuda"),
        ops.bfs_relax_csr(dist, frontier, layout, backend="torch"),
        "min",
    )


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BUILTIN_PROGRAMS))
def test_engine_on_cuda_matches_torch_backend(cuda_device, name):
    g = weighted(rmat_graph(9, 8, seed=3), seed=2)
    host = bfs_grow_partition(g, 5, seed=1)
    pg = partitioned_graph_from_numpy(
        g.n_vertices, g.src, g.dst, g.weights, host.n_parts, host.part_of_vertex
    )
    results = {}
    for backend in ("cuda", "torch"):
        cfg = EngineConfig(device="cuda", backend=backend, m_max=64)
        before = relax_rowptr.launches
        results[backend] = TraversalEngine(
            pg, program=BUILTIN_PROGRAMS[name](), config=cfg
        ).run([0, 37, 200])
        launched = relax_rowptr.launches - before
        assert (launched > 0) == (backend == "cuda")
    kern, plain = results["cuda"], results["torch"]
    for field in kern._fields:
        a, b = getattr(kern, field), getattr(plain, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if field == "dist" and name == "pagerank":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
            exact = reference_pagerank(pg, 0.85, 20)
            for row in a:
                np.testing.assert_allclose(row, exact, rtol=1e-5, atol=1e-9)
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)
