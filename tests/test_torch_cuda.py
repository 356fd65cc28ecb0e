"""The CUDA kernels on the card, against their plain versions: relax,
segment sum, flash attention and the partition counters; the elastic executor and the serving
loop on the card, whose reports must equal the ``torch`` backend's; and
the GNN models, whose every segment sum runs on the kernel, against the
``torch`` backend (halo PNA against the dense forward).

Every test here needs an NVIDIA card with ``nvcc`` and skips with a reason
elsewhere.  The file imports neither JAX nor the JAX package, so it runs on
a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances.  Partition counters: bit-exact, and the engine's counters
bit-identical across backends.  Relax: ``min`` is bit-exact; ``sum`` is ``rtol=1e-5,
atol=1e-9`` (both sum float32 in float64, in different orders).  Segment
sum: per segment, ``|kernel - plain| <= 1e-5 * sum(|vals|)`` over the
segment (both sum in float32, in different orders; an empty segment is
exactly 0).  Flash attention: ``1e-5`` in float32 (both in float32 FMAs,
TF32 off), ``2e-2`` in bfloat16 (the kernel rounds P to bfloat16 for the
PV product, as the TPU kernel does), the JAX tests' tolerances; bfloat16
also within ``bf16_tolerance_ratio``'s bound, which scales with each row.
Executor and service: BFS state bit-identical, reports equal field by field
(except wall seconds), as on the CPU against the JAX package.  Mesh: two
ranks (``repro_torch.dist.run_ranks``) share the card over gloo, or run on
two cards over NCCL where two are visible; state and every counter equal
the dense engine's on the card (PageRank state to rtol 1e-5).  GNN models
(reduced configs): node outputs within 2e-4 and energies within 1e-5 of
their largest magnitude, PNA grads (float32 through the kernel) at rtol
1e-3 / atol 1e-5 of the plain version's float64 grads, halo PNA on two
ranks within 2e-4 of the dense forward.  LM and recsys: GQA attention
through the kernel against the plain paths at the flash tolerances above
(float32 ``2e-5``, the reference's chunked-against-dense bound); the MoE
combine bit-identical over two calls; the ragged embedding bag at D = 10
per bag within ``1e-6`` of its sum of |rows| against float64.  Training:
the flash entry refuses a gradient; MeshGraphNet's train-loss grads
through the kernel (sums and the gathers' gradients) at rtol 1e-3 / atol
1e-5 of the plain version's float64 grads; a GNN crash and restart equal
the straight run bit for bit; an LM train step launches no flash kernel.
Data-parallel training: 2 ranks (gloo on one card, or NCCL on two) of a
reduced LM's train step in float32 against one rank on the card, within
``tests/test_torch_dp.py``'s bound on the CPU (loss and gradient norm
``1e-6``, float32 reassociation), every rank's state (gathered whole: the
LM's is FSDP-sharded) equal bit for bit and DeepSeek-V3's router biases
equal to one rank's.  The model axis: a reduced LM's float32 prefill on a
``(1, 2)`` mesh, each rank on its own heads, launches the flash kernel
once a layer on every rank; its next tokens equal one rank's and its
last-position logits lie within ``tests/test_torch_tp.py``'s ``1e-5`` of
their rms.  Split-KV decode: a reduced LM's float32 decode on a ``(1, 2)``
mesh, half the cache's slots a rank, within ``tests/test_torch_dryrun.py``'s
``2e-5`` of one rank's logits' rms; a merge without its rescale must fail it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.convert import partitioned_graph_from_numpy
from repro_torch.core import STRATEGIES, TimeFunction, predict_time_function
from repro_torch.core.elastic import ElasticBSPExecutor
from repro_torch.graph import EdgeDeltaBuffer, bsp
from repro_torch.graph import bfs_grow_partition, rmat_graph, weighted
from repro_torch.graph.config import EngineConfig
from repro_torch.graph.program import BUILTIN_PROGRAMS, BfsProgram
from repro_torch.graph.structs import dst_sorted_layout, row_ptr_for
from repro_torch.graph.traversal import TraversalEngine, reference_bfs, reference_pagerank
from repro_torch.kernels.bfs_relax import ops
from repro_torch.kernels.bfs_relax.kernel import relax_rowptr
from repro_torch.kernels.bfs_relax.ref import relax_reference
from repro_torch.kernels.flash_attention import (
    attention_rows,
    bf16_tolerance_ratio,
    flash_attention,
    flash_fwd,
    reference_attention,
)
from repro_torch.kernels.flash_attention.kernel import variant_for
from repro_torch.kernels.part_count import part_count, part_counts, part_counts_reference
from repro_torch.kernels.segment_sum import (
    reference_segment_sum,
    segment_sum_sorted,
    sorted_segment_sum,
)
from repro_torch.kernels.segment_sum.kernel import segment_levels
from repro_torch.serve import ServiceConfig, TraversalService, poisson_trace
from repro_torch.serve.batcher import MicroBatcher

SHAPES = {
    # name: (S, n, e, dst): "uniform" ids, zipf(1.5) "powerlaw" ids, or
    # uniform ids plus 2**21 in-edges on vertex n // 3 ("hub_2m", spread
    # over about a thousand tiles of the merge-path split)
    "ragged": (3, 257, 1023, "uniform"),
    "hub": (2, 16, 600, "uniform"),
    "e0": (3, 50, 0, "uniform"),
    "n_lt_8": (3, 5, 9, "uniform"),
    "single_edge": (3, 40, 1, "uniform"),
    "hub_2m": (2, 300_000, 1_000_000, "hub_2m"),
    "powerlaw": (2, 500_000, 3_000_000, "powerlaw"),
    # the serving path's batch of 8 rows
    "serve_batch": (8, 200_000, 1_500_000, "powerlaw"),
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
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(s, n, e, reduce, dtype, seed, kind="uniform"):
    rng = np.random.default_rng(seed)
    if kind == "powerlaw":
        dst = rng.zipf(1.5, e) % n
    else:
        dst = rng.integers(0, n, e)
    if kind == "hub_2m":
        dst = np.concatenate([dst, np.full(2**21, n // 3)])
    dst = np.sort(dst).astype(np.int32)
    e = len(dst)
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
    """Min bit-exact; sum within tolerance and the same bits on a second
    run (no atomics)."""
    reduce, dtype = variant
    s, n, e, kind = SHAPES[shape]
    dst, cand, base = _inputs(s, n, e, reduce, dtype, seed=n * 13 + e, kind=kind)
    on = dict(device=cuda_device)
    cand_t, base_t = torch.as_tensor(cand, **on), torch.as_tensor(base, **on)
    row_ptr = torch.as_tensor(row_ptr_for(dst, n), **on)
    before = relax_rowptr.launches
    out = relax_rowptr(row_ptr, cand_t, base_t, reduce=reduce)
    again = relax_rowptr(row_ptr, cand_t, base_t, reduce=reduce)
    ref = relax_reference(torch.as_tensor(dst.astype(np.int64), **on), cand_t, base_t, reduce)
    torch.cuda.synchronize()
    assert relax_rowptr.launches == before + 2
    assert torch.equal(out, again)
    _assert_close(out, ref, reduce)


@pytest.mark.cuda
def test_relax_tile_split_follows_row_ptr_edits(cuda_device):
    """The wrapper reuses a row_ptr's tile split across calls; an in-place
    edit of row_ptr makes it split again."""
    s, n, e = 2, 3000, 20000
    dst, cand, base = _inputs(s, n, e, "min", np.float32, seed=11, kind="powerlaw")
    on = dict(device=cuda_device)
    cand_t, base_t = torch.as_tensor(cand, **on), torch.as_tensor(base, **on)
    row_ptr = torch.as_tensor(row_ptr_for(dst, n), **on)
    _assert_close(relax_rowptr(row_ptr, cand_t, base_t, reduce="min"),
                  relax_reference(torch.as_tensor(dst.astype(np.int64), **on), cand_t, base_t,
                                  "min"), "min")
    dst2 = np.sort(np.random.default_rng(12).integers(0, n, e)).astype(np.int32)
    row_ptr.copy_(torch.as_tensor(row_ptr_for(dst2, n), **on))
    _assert_close(relax_rowptr(row_ptr, cand_t, base_t, reduce="min"),
                  relax_reference(torch.as_tensor(dst2.astype(np.int64), **on), cand_t, base_t,
                                  "min"), "min")


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
    from torch.profiler import ProfilerActivity, profile

    results = {}
    for backend in ("cuda", "torch"):
        cfg = EngineConfig(device="cuda", backend=backend, m_max=64)
        before = relax_rowptr.launches
        eng = TraversalEngine(pg, program=BUILTIN_PROGRAMS[name](), config=cfg)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            results[backend] = eng.run([0, 37, 200])
        launched = relax_rowptr.launches - before
        assert (launched > 0) == (backend == "cuda")
        # one counters kernel launch a partition-counter call, and none on torch
        counters = sum(1 for ev in prof.events() if ev.name == "engine.counters")
        assert counters > 0
        assert eng.part_count_launches == (counters if backend == "cuda" else 0)
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


# -- the partition counters --------------------------------------------------------

#: the largest degree of the LiveJournal-sized R-MAT graph of
#: ``bench/configs/livj-8p.json`` (measured on its instance)
LIVJ_MAX_DEGREE = 93_326


def _count_inputs(r, n, p, n_weights, none_at, density, device, seed, max_weight=5000):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((r, n), generator=gen, device=device) < density
    part_of = torch.randint(0, p, (n,), generator=gen, device=device, dtype=torch.int32)
    drop = torch.rand(n, generator=gen, device=device) < 0.1
    part_of = torch.where(drop, torch.full_like(part_of, -1), part_of)
    weights = tuple(
        None if w in none_at else torch.randint(
            0, max_weight + 1, (n,), generator=gen, device=device, dtype=torch.int32)
        for w in range(n_weights)
    )
    return x, weights, part_of


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.3, 1.0, 0.001])
@pytest.mark.parametrize("r", [1, 3, 16, 32])
@pytest.mark.parametrize("p", [1, 8, 40])
@pytest.mark.parametrize(
    "n_weights,none_at", [(1, ()), (2, (1,)), (3, (2,)), (3, (0, 2))],
    ids=["w1", "w2-none", "w3-none", "w3-two-none"],
)
def test_part_count_kernel_matches_plain_version(cuda_device, r, p, n_weights, none_at, density):
    """Bit for bit, at an n that is not a multiple of 16 (a last, partial
    chunk, and rows that start off any word boundary) and with ids of -1
    (rows that count nowhere)."""
    n = 4096 * 3 + 16 * 5 + 7
    x, weights, part_of = _count_inputs(r, n, p, n_weights, none_at, density, cuda_device,
                                        seed=r * 100 + p)
    before = part_count.launches
    out = part_count(x, weights, part_of, p)
    ref = part_counts_reference(x, weights, part_of, p)
    torch.cuda.synchronize()
    assert part_count.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (n_weights * r, p)
    assert torch.equal(out, ref)
    assert torch.equal(part_counts(x, weights, part_of, p), ref)  # the entry's default


@pytest.mark.cuda
@pytest.mark.parametrize("r,p,n_weights,n", [
    (32, 8, 2, 5_062_474), (16, 8, 1, 5_062_474), (16, 40, 3, 5_062_474), (200, 40, 3, 300_007),
])
def test_part_count_kernel_at_the_main_path_shape(cuda_device, r, p, n_weights, n):
    """LiveJournal's vertices, weights up to its largest degree, a sparse
    and an all-true frontier; and a shape whose counters fill more than one
    row group."""
    for density in (0.01, 1.0):
        x, weights, part_of = _count_inputs(
            r, n, p, n_weights, (n_weights - 1,), density, cuda_device, seed=r + p,
            max_weight=LIVJ_MAX_DEGREE,
        )
        out = part_count(x, weights, part_of, p)
        ref = part_counts_reference(x, weights, part_of, p)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (density, (out - ref).abs().max())


@pytest.mark.cuda
def test_part_count_kernel_refuses_a_zero_row_launch(cuda_device):
    part_of = torch.zeros(100, dtype=torch.int32, device=cuda_device)
    before = part_count.launches
    with pytest.raises(ValueError, match="zero dimension"):
        part_count(torch.zeros((0, 100), dtype=torch.bool, device=cuda_device), (None,),
                   part_of, 8)
    assert part_count.launches == before
    # the entry answers an empty frontier without a launch
    empty = part_counts(torch.zeros((0, 100), dtype=torch.bool, device=cuda_device),
                        (None,), part_of, 8)
    assert empty.shape == (0, 8) and part_count.launches == before


SEG_SHAPES = {
    # name: (E, N, D, vals dtype, ids dtype, skew[, row offset]): ids uniform,
    # zipf(1.5) "powerlaw", "out_of_range" or "hub" (90% on one segment, a
    # run over many blocks' spans); a row offset makes ids and vals views
    # that start that many rows into their tensors (a head the kernel peels)
    "e0": (0, 64, 16, torch.float32, torch.int32, "uniform"),
    "n_lt_8": (50, 5, 16, torch.float32, torch.int32, "uniform"),
    "single_edge": (1, 40, 16, torch.float32, torch.int32, "uniform"),
    "d10": (5000, 300, 10, torch.float32, torch.int32, "uniform"),
    "d33": (5000, 300, 33, torch.float32, torch.int64, "powerlaw"),
    "d75": (5000, 300, 75, torch.float32, torch.int32, "powerlaw"),
    "bf16": (4096, 256, 64, torch.bfloat16, torch.int32, "uniform"),
    "bf16_d10": (4096, 256, 10, torch.bfloat16, torch.int64, "powerlaw"),
    "out_of_range": (3000, 100, 32, torch.float32, torch.int32, "out_of_range"),
    "hub_levels": (1_000_000, 1000, 32, torch.float32, torch.int32, "powerlaw"),
    "d1": (300_000, 5000, 1, torch.float32, torch.int32, "powerlaw"),
    "d75_int64": (60_000, 2000, 75, torch.float32, torch.int64, "powerlaw"),
    "bf16_d75": (60_000, 2000, 75, torch.bfloat16, torch.int32, "uniform"),
    "d1152": (8192, 3840, 1152, torch.float32, torch.int32, "uniform"),
    "offset_view_d75": (30_000, 900, 75, torch.float32, torch.int32, "powerlaw", 1),
    "offset_view_bf16_d33": (30_000, 900, 33, torch.bfloat16, torch.int64, "uniform", 1),
    "hub_spans": (1_000_000, 100, 128, torch.float32, torch.int32, "hub"),
}


def _seg_inputs(e, n, d, vdtype, idtype, skew, device, seed, offset=0):
    rng = np.random.default_rng(seed)
    if skew == "powerlaw":
        raw = rng.zipf(1.5, e) % n
    elif skew == "out_of_range":
        raw = rng.integers(-5, n + 5, e)
    elif skew == "hub":
        raw = np.where(rng.random(e) < 0.9, n // 3, rng.integers(0, n, e))
    else:
        raw = rng.integers(0, n, e)
    ids = torch.as_tensor(np.sort(raw), device=device).to(idtype)
    vals = torch.as_tensor(rng.standard_normal((e, d)).astype(np.float32), device=device)
    vals = vals.to(vdtype)
    if offset:  # views `offset` rows into larger tensors
        ids = torch.cat([ids[:offset], ids])[offset:]
        vals = torch.cat([vals[:offset], vals])[offset:]
        assert ids.storage_offset() == vals.storage_offset() // d == offset
    return ids, vals


def _assert_seg_close(out, ids, vals, n):
    ref = reference_segment_sum(ids, vals, n)
    scale = reference_segment_sum(ids, vals.float().abs(), n)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    err = (out - ref).abs()
    assert bool((err <= 1e-5 * scale).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SEG_SHAPES))
def test_segment_sum_kernel_matches_plain_version(cuda_device, shape):
    e, n, d, vdtype, idtype, skew, *offset = SEG_SHAPES[shape]
    ids, vals = _seg_inputs(e, n, d, vdtype, idtype, skew, cuda_device, seed=e + d,
                            offset=offset[0] if offset else 0)
    before = segment_sum_sorted.launches
    out = sorted_segment_sum(ids, vals, n, assume_sorted=True)
    again = sorted_segment_sum(ids, vals, n, assume_sorted=True)
    torch.cuda.synchronize()
    levels = len(segment_levels(e, d)) if e else 0
    assert segment_sum_sorted.launches == before + 2 * levels
    assert torch.equal(out, again)  # no atomics: the same bits every run
    _assert_seg_close(out, ids, vals, n)


@pytest.mark.cuda
def test_segment_sum_unsorted_ids_on_cuda(cuda_device):
    ids, vals = _seg_inputs(7000, 90, 24, torch.float32, torch.int32, "powerlaw",
                            cuda_device, seed=1)
    perm = torch.randperm(7000, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    out = sorted_segment_sum(ids[perm], vals[perm], 90)
    _assert_seg_close(out, ids, vals, 90)
    torch.testing.assert_close(
        out, sorted_segment_sum(ids[perm], vals[perm], 90, backend="torch"),
        atol=1e-4, rtol=1e-4,
    )


FLASH_SHAPES = {
    # name: (B, S, H, Hk, d, causal, window, dtype)
    "f32_gqa": (2, 256, 4, 2, 64, True, None, torch.float32),
    "f32_d128": (1, 128, 2, 2, 128, True, None, torch.float32),
    "f32_window": (2, 256, 4, 4, 64, True, 64, torch.float32),
    "f32_ragged_mqa_d48": (1, 160, 2, 1, 48, True, None, torch.float32),
    "f32_window_128": (1, 512, 8, 2, 64, True, 128, torch.float32),
    "f32_ragged_noncausal": (1, 160, 2, 1, 64, False, None, torch.float32),
    "f32_noncausal_window": (1, 200, 2, 1, 64, False, 64, torch.float32),
    "bf16_gqa": (2, 256, 4, 2, 64, True, None, torch.bfloat16),
    "bf16_d96": (1, 384, 6, 3, 96, True, None, torch.bfloat16),
    "bf16_mqa_d128": (1, 700, 8, 1, 128, True, None, torch.bfloat16),
    "bf16_window": (1, 1000, 4, 2, 128, True, 256, torch.bfloat16),
    "bf16_window_mid_tile": (1, 1000, 8, 2, 128, True, 200, torch.bfloat16),
    "bf16_window_65": (2, 700, 6, 3, 96, True, 65, torch.bfloat16),
    "bf16_ragged_noncausal": (1, 160, 2, 1, 64, False, None, torch.bfloat16),
    "bf16_noncausal_window": (1, 200, 2, 1, 64, False, 64, torch.bfloat16),
    "bf16_odd_d33": (1, 130, 2, 2, 33, True, None, torch.bfloat16),
    "bf16_d16": (2, 100, 2, 1, 16, False, 20, torch.bfloat16),
    # S not a multiple of the wgmma kernel's 128-row tiles
    "bf16_s333_causal_d64": (2, 333, 4, 2, 64, True, None, torch.bfloat16),
    "bf16_s200_noncausal_d128": (1, 200, 4, 1, 128, False, None, torch.bfloat16),
    "bf16_s129_window_d40": (1, 129, 2, 1, 40, True, 50, torch.bfloat16),
    "bf16_s1_d128": (1, 1, 2, 1, 128, True, None, torch.bfloat16),
    "bf16_s1100_noncausal_window_d96": (1, 1100, 4, 2, 96, False, 300, torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_kernel_matches_plain_version(cuda_device, shape):
    b, s, h, hk, d, causal, window, dtype = FLASH_SHAPES[shape]
    rng = np.random.default_rng(s + d)
    q, k, v = (
        torch.as_tensor(rng.standard_normal(sh).astype(np.float32), device=cuda_device).to(dtype)
        for sh in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))
    )
    before = flash_fwd.launches
    variants = dict(flash_fwd.variant_launches)
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = reference_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    took = variant_for(d, dtype, aligned=True)  # fresh tensors start on 16 bytes
    assert took == ("float32" if dtype == torch.float32
                    else "bfloat16-wgmma" if d % 8 == 0 else "bfloat16-mma")
    assert {k_: n_ - variants[k_] for k_, n_ in flash_fwd.variant_launches.items()
            if n_ != variants[k_]} == {took: 1}
    assert out.dtype == dtype and out.shape == q.shape
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        exact = attention_rows(q, k, v, 0, s, causal=causal, window=window)
        assert bf16_tolerance_ratio(out, exact) <= 1.0


@pytest.mark.cuda
def test_flash_unaligned_bf16_takes_the_mma_kernel(cuda_device):
    """A bfloat16 base off 16 bytes goes to the mma.sync kernel (TMA needs
    16-byte bases), by shape and before any launch."""
    b, s, h, hk, d = 1, 300, 4, 2, 64
    rng = np.random.default_rng(5)

    def off_by_one(shape):
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
        flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
        t = flat[1:].view(shape)
        t.copy_(x)
        return t

    q, k, v = off_by_one((b, s, h, d)), off_by_one((b, s, hk, d)), off_by_one((b, s, hk, d))
    before = flash_fwd.variant_launches["bfloat16-mma"]
    out = flash_attention(q, k, v, causal=True, window=None)
    torch.cuda.synchronize()
    assert flash_fwd.variant_launches["bfloat16-mma"] == before + 1
    exact = attention_rows(q, k, v, 0, s, causal=True, window=None)
    assert bf16_tolerance_ratio(out, exact) <= 1.0


def _execution_fields(rep):
    out = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)}
    del out["wall_seconds"]
    out["actual_tau"] = out["actual_tau"].tau
    out["cost"] = dataclasses.asdict(out["cost"])
    return out


def _assert_fields_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.cuda
@pytest.mark.parametrize("mutate", [False, True], ids=["static-graph", "mutations"])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_elastic_run_on_cuda_matches_torch_backend(cuda_device, strategy, mutate):
    pg = bfs_grow_partition(rmat_graph(10, 8, seed=3), 8, seed=1)
    _, trace = bsp.run_sssp(pg, 0, config=EngineConfig(device="cuda"))
    tf = TimeFunction.from_trace(trace)
    plan = STRATEGIES[strategy](tf)
    muts = None
    if mutate:
        rng = np.random.default_rng(0)
        buf = EdgeDeltaBuffer()
        buf.insert_many(rng.integers(0, pg.graph.n_vertices, 64),
                        rng.integers(0, pg.graph.n_vertices, 64))
        muts = [(1, buf)]
    reports = []
    for backend in ("cuda", "torch"):
        cfg = EngineConfig(device="cuda", backend=backend, window=1 if mutate else 3)
        ex = ElasticBSPExecutor(pg, program=BfsProgram(), tau_scale=21.0 / tf.t_min(),
                                config=cfg)
        before = relax_rowptr.launches
        reports.append(ex.run(0, plan, strategy_fn=STRATEGIES[strategy], replan=True,
                              sketch=predict_time_function(pg, 0)[0], mutations=muts))
        assert (relax_rowptr.launches > before) == (backend == "cuda")
    _assert_fields_equal(*(_execution_fields(r) for r in reports))
    if mutate:
        assert reports[0].mutations_applied == 1
        np.testing.assert_array_equal(reports[0].dist, reference_bfs(ex.pg, 0))
    else:
        np.testing.assert_array_equal(reports[0].dist, reference_bfs(pg, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("s_batch", [4, 8])
def test_served_trace_on_cuda_matches_torch_backend(cuda_device, monkeypatch, s_batch):
    """Equal reports, and every completed query's state row (kept as its
    batch row retires; its last retirement is its completion) equal to the
    host BFS from its source."""
    rows = {}
    retire = MicroBatcher.retire

    def keep(self, row):
        rec = retire(self, row)
        rows[(self.engine.backend, rec.qid)] = self.state.dist[row].cpu().numpy()
        return rec

    monkeypatch.setattr(MicroBatcher, "retire", keep)
    pg = bfs_grow_partition(rmat_graph(10, 8, seed=3), 8, seed=1)
    cfg = ServiceConfig(s_batch=s_batch, window=4, tau_scale=1e3)
    trace = poisson_trace(24, 20.0, pg.graph.n_vertices, seed=5)
    reports = [
        TraversalService(pg, config=cfg,
                         engine_config=EngineConfig(device="cuda", backend=b)).run(trace)
        for b in ("cuda", "torch")
    ]
    assert reports[0].asdict() == reports[1].asdict()
    assert reports[0].completed == 24
    for q in reports[0].queries:
        np.testing.assert_array_equal(rows[("cuda", q.qid)], reference_bfs(pg, q.source))
        np.testing.assert_array_equal(rows[("torch", q.qid)], rows[("cuda", q.qid)])


@pytest.mark.cuda
def test_serving_lane_splits_each_layout_once(cuda_device):
    """Across two traces of one lane the relax kernel runs every window,
    and its partition kernel never again after the lane's first window."""
    pg = bfs_grow_partition(rmat_graph(10, 8, seed=4), 8, seed=1)
    svc = TraversalService(pg, config=ServiceConfig(s_batch=4, window=4, tau_scale=1e3),
                           engine_config=EngineConfig(device="cuda", backend="cuda"))
    svc.run(poisson_trace(12, 50.0, pg.graph.n_vertices, seed=1))
    launches, splits = relax_rowptr.launches, relax_rowptr.partition_launches
    svc.run(poisson_trace(12, 0.5, pg.graph.n_vertices, seed=2))
    assert relax_rowptr.launches > launches
    assert relax_rowptr.partition_launches == splits
    assert len(pg.__dict__["_traversal_engines"]) == 1


# -- the multi-GPU engine on the card ----------------------------------------------


def _mesh_graph():
    return bfs_grow_partition(weighted(rmat_graph(10, 8, seed=3), seed=2), 5, seed=1)


def _rank_mesh_run(name: str, mirror_degree) -> dict:
    """One rank's run of ``name`` on the mesh, with the relax kernel's
    launches on this rank and the rank's transport."""
    from repro_torch.dist import partition_mesh

    mesh = partition_mesh()
    before = relax_rowptr.launches
    eng = TraversalEngine(
        _mesh_graph(), program=BUILTIN_PROGRAMS[name](),
        config=EngineConfig(device="cuda", mesh=mesh, m_max=64, mirror_degree=mirror_degree),
    )
    res = eng.run([0, 37, 200])
    return {
        "result": {f: getattr(res, f) for f in res._fields},
        "launches": relax_rowptr.launches - before,
        "part_count_launches": eng.part_count_launches,
        "holds_edges": eng._mesh_prog.layout.plane("local", mesh.rank)[2]
        + eng._mesh_prog.layout.plane("wire", mesh.rank)[2] > 0,
        "mesh": mesh.describe(),
    }


def _assert_mesh_equals_dense(ranks, name):
    dense = TraversalEngine(
        _mesh_graph(), program=BUILTIN_PROGRAMS[name](),
        config=EngineConfig(device="cuda", m_max=64),
    ).run([0, 37, 200])
    for rank in ranks:
        assert not rank["holds_edges"] or rank["launches"] > 0
        assert rank["part_count_launches"] > 0
        res = rank["result"]
        for field in dense._fields:
            a, b = res[field], getattr(dense, field)
            if field == "wire_msgs":
                assert a.sum() > 0 and b.sum() == 0
            elif field == "dist" and name == "pagerank":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
            else:
                assert a.dtype == b.dtype and a.shape == b.shape, field
                np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.cuda
@pytest.mark.parametrize("mirror_degree", [None, 4], ids=["plain", "mirrored"])
@pytest.mark.parametrize("name", sorted(BUILTIN_PROGRAMS))
def test_gloo_mesh_on_one_card_matches_dense_engine(cuda_device, name, mirror_degree):
    from repro_torch.dist import run_ranks

    if torch.cuda.device_count() >= 2:
        pytest.skip("each rank gets its own card here: the NCCL test covers it")
    relax_rowptr.load()  # build once here, not in both ranks at once
    ranks = run_ranks(_rank_mesh_run, 2, device="cuda", timeout=600,
                      args=(name, mirror_degree))
    assert ranks.backend == "gloo" and ranks.devices == ["cuda:0", "cuda:0"]
    assert all(r["mesh"]["transport"] == "direct" for r in ranks)
    _assert_mesh_equals_dense(ranks, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bfs", "pagerank"])
def test_nccl_mesh_on_two_cards_matches_dense_engine(cuda_device, name):
    from repro_torch.dist import run_ranks

    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs a card per rank; this machine has one")
    relax_rowptr.load()
    ranks = run_ranks(_rank_mesh_run, 2, device="cuda", timeout=600, args=(name, None))
    assert ranks.backend == "nccl" and ranks.devices == ["cuda:0", "cuda:1"]
    assert all(r["mesh"]["transport"] == "direct" for r in ranks)
    _assert_mesh_equals_dense(ranks, name)


# -- the GNN stack on the card ---------------------------------------------------


def _gnn_graph(device, n=300, e=2400, seed=5):
    rng = np.random.default_rng(seed)
    src = torch.as_tensor(rng.integers(0, n, e), device=device)
    dst = torch.as_tensor(rng.integers(0, n - 10, e), device=device)  # 10 isolated
    mask = torch.as_tensor(rng.random(e) < 0.8, device=device)
    return n, src, dst, mask


def _gnn_runs(name, device):
    """``run(backend)`` for one reduced-config model on the card, at
    seeded inputs, and the bound its cuda and torch outputs must meet."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.gnn import MACE, PNA, DimeNet, MeshGraphNet, build_triplets

    cfg = reduced_config(ARCHS[name])
    gen = torch.Generator().manual_seed(3)
    n, src, dst, mask = _gnn_graph(device)
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((n, 12)).astype(np.float32), device=device)
    pos = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32), device=device)
    species = torch.as_tensor(rng.integers(0, 10, n), device=device)
    gid = torch.as_tensor(np.repeat(np.arange(3), n // 3), device=device)
    if name == "pna":
        model = PNA(cfg, 12, 5, generator=gen, device=device)
        return lambda b: model(x, src, dst, edge_mask=mask, backend=b), 2e-4
    if name == "meshgraphnet":
        model = MeshGraphNet(cfg, 12, 4, 3, generator=gen, device=device)
        ef = torch.as_tensor(rng.standard_normal((src.shape[0], 4)).astype(np.float32),
                             device=device)
        return lambda b: model(x, ef, src, dst, edge_mask=mask, backend=b), 2e-4
    if name == "mace":
        model = MACE(cfg, generator=gen, device=device)
        return lambda b: model(species, pos, src, dst, graph_id=gid, n_graphs=3,
                               backend=b), 1e-5
    kj, ji, tmask = build_triplets(src.cpu().numpy(), dst.cpu().numpy(), 6000)
    model = DimeNet(cfg, generator=gen, device=device)
    kj, ji, tmask = (torch.as_tensor(a, device=device) for a in (kj, ji, tmask))
    return lambda b: model(species, pos, src, dst, kj, ji, trip_mask=tmask, graph_id=gid,
                           n_graphs=3, backend=b), 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pna", "meshgraphnet", "mace", "dimenet"])
def test_gnn_forward_on_cuda_matches_torch_backend(cuda_device, name):
    """Each model on backend ``cuda`` (every segment sum on the kernel,
    counted) against ``torch``: outputs within the stated share of their
    largest magnitude (2e-4 for node outputs, 1e-5 for energies)."""
    run, tol = _gnn_runs(name, cuda_device)
    with torch.no_grad():
        before = segment_sum_sorted.launches
        out = run("cuda")
        torch.cuda.synchronize()
        assert segment_sum_sorted.launches > before
        ref = run("torch")
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    err = float((out - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    assert err <= tol, err


@pytest.mark.cuda
def test_pna_grads_through_the_kernel_match_the_plain_version(cuda_device):
    """The autograd entry (kernel forward, gather backward) in float32
    against the plain version run in float64 on the same parameters and
    inputs, at rtol 1e-3, atol 1e-5.  The float64 grads stand for the exact
    ones: a float32 plain run would add by ``index_add_``'s atomics, in an
    order that changes from run to run."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.gnn import PNA

    cfg = reduced_config(ARCHS["pna"])
    n, src, dst, mask = _gnn_graph(cuda_device)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((n, 12)).astype(np.float32), device=cuda_device)
    labels = torch.as_tensor(rng.integers(0, 5, n), device=cuda_device)
    grads = {}
    for backend, dtype in (("cuda", torch.float32), ("torch", torch.float64)):
        model = PNA(cfg, 12, 5, generator=torch.Generator().manual_seed(1),
                    device=cuda_device).to(dtype)
        lg = model(x.to(dtype), src, dst, edge_mask=mask, backend=backend)
        assert lg.dtype == dtype
        torch.nn.functional.cross_entropy(lg, labels).backward()
        grads[backend] = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads["cuda"].items():
        torch.testing.assert_close(g, grads["torch"][k].float(), rtol=1e-3, atol=1e-5, msg=k)


def _halo_card_rank(plan, xs, seed) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.configs.registry import reduced_config
    from repro_torch.dist import partition_mesh
    from repro_torch.models.gnn.halo_pna import PNA, pna_forward_halo, rank_inputs

    mesh = partition_mesh()
    model = PNA(reduced_config(ARCHS["pna"]), 12, 5,
                generator=torch.Generator().manual_seed(seed), device=mesh.device)
    before = segment_sum_sorted.launches
    with torch.no_grad():
        out = pna_forward_halo(model, mesh, **rank_inputs(plan, xs, mesh.rank, mesh.device))
    torch.cuda.synchronize()
    return {"out": out.cpu().numpy(), "launches": segment_sum_sorted.launches - before,
            "calls": mesh.stats.snapshot()["calls"]}


@pytest.mark.cuda
def test_halo_pna_on_two_ranks_of_one_card_matches_dense(cuda_device):
    from repro_torch.configs import ARCHS
    from repro_torch.configs.registry import reduced_config
    from repro_torch.dist import run_ranks
    from repro_torch.dist.halo import build_halo_plan, scatter_nodes
    from repro_torch.models.gnn import PNA

    segment_sum_sorted.load()  # build once here, not in both ranks at once
    pg = bfs_grow_partition(rmat_graph(10, 6, seed=3), 2, seed=1)
    plan = build_halo_plan(pg)
    x = np.random.default_rng(8).standard_normal((pg.graph.n_vertices, 12)).astype(np.float32)
    ranks = run_ranks(_halo_card_rank, 2, device="cuda", timeout=600,
                      args=(plan, scatter_nodes(plan, x), 4))
    model = PNA(reduced_config(ARCHS["pna"]), 12, 5, generator=torch.Generator().manual_seed(4),
                device=cuda_device)
    with torch.no_grad():
        dense = model(torch.as_tensor(x, device=cuda_device),
                      torch.as_tensor(pg.graph.src, device=cuda_device),
                      torch.as_tensor(pg.graph.dst, device=cuda_device)).cpu().numpy()
    flat = np.concatenate([r["out"] for r in ranks]).reshape(2 * plan.n_local, -1)
    np.testing.assert_allclose(flat[plan.perm], dense, atol=2e-4)
    for r in ranks:
        assert r["launches"] > 0 and r["calls"] == {"all_to_all": 2}


# -- the LM and recsys stacks on the card -------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("width", ["reduced", "mid"])
def test_gqa_forward_through_the_kernel_matches_the_plain_paths(cuda_device, width, window,
                                                                dtype):
    """``gqa_attend`` on the card (the flash kernel, counted; bfloat16 with
    d % 8 == 0 takes the TMA/wgmma kernel) against the plain ``_sdpa`` path
    and float32 ``attention_rows`` on the same rope'd q, k, v; and the whole
    ``gqa_forward`` across backends."""
    from repro_torch.configs.base import LMConfig
    from repro_torch.models import attention as A

    dims = {"reduced": (64, 4, 2, 16), "mid": (1024, 16, 4, 64)}[width]
    d, h, hk, dh = dims
    cfg = LMConfig(name="t", n_layers=1, d_model=d, n_heads=h, n_kv_heads=hk, d_head=dh,
                   d_ff=4 * d, vocab=64, sliding_window=window)
    p = A.GQAAttention(cfg, generator=torch.Generator().manual_seed(2), dtype=dtype).to(
        cuda_device)
    x = torch.randn((2, 700, d), generator=torch.Generator().manual_seed(3)).to(
        cuda_device, dtype)
    variant = variant_for(dh, dtype, True)
    with torch.inference_mode():
        q, k, v = A.gqa_qkv(p, cfg, x)
        before = flash_fwd.variant_launches[variant]
        out = A.gqa_attend(q, k, v, cfg)
        torch.cuda.synchronize()
        assert flash_fwd.variant_launches[variant] == before + 1
        plain = A.gqa_attend(q, k, v, cfg, backend="torch")
        assert flash_fwd.variant_launches[variant] == before + 1
        ref = attention_rows(q, k, v, 0, q.shape[1], causal=True, window=window)
        fwd = A.gqa_forward(p, cfg, x)
        fwd_plain = A.gqa_forward(p, cfg, x, backend="torch")
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(fwd, fwd_plain, atol=1e-4, rtol=1e-4)
    else:
        assert variant == "bfloat16-wgmma"
        assert bf16_tolerance_ratio(out, ref) <= 1.0
        torch.testing.assert_close(out.float(), plain.float(), atol=2e-2, rtol=2e-2)
        scale = float(fwd_plain.float().abs().max())
        assert float((fwd.float() - fwd_plain.float()).abs().max()) <= 2e-2 * max(1.0, scale)


@pytest.mark.cuda
def test_moe_combine_is_deterministic_on_the_card(cuda_device):
    """Two calls of ``moe_ffn`` on the card give the same bits (the combine
    gathers; nothing adds atomically), with capacity drops on the path."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import MoE, moe_ffn, route

    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=256, capacity_factor=0.75)
    p = MoE(512, cfg, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    x = torch.randn((8192, 512), generator=torch.Generator().manual_seed(5)).to(
        cuda_device, torch.bfloat16)
    with torch.inference_mode():
        y1, aux1, load1 = moe_ffn(p, cfg, x)
        y2, aux2, load2 = moe_ffn(p, cfg, x)
        assert not bool(route(p, cfg, x).kept().all())
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2) and torch.equal(load1, load2)
    assert bool(torch.isfinite(y1.float()).all())


@pytest.mark.cuda
def test_embedding_bag_segment_on_the_kernel_at_d10(cuda_device):
    """The ragged bag through the segment-sum kernel (counted) at DeepFM's
    D = 10, bags of 0 to 40 ids in shuffled order, per bag within 1e-6 of
    its sum of |rows| of a float64 sum; empty bags exactly 0."""
    from repro_torch.models.recsys import embedding_bag_segment

    rng = np.random.default_rng(6)
    table = torch.as_tensor(rng.standard_normal((100_000, 10)).astype(np.float32),
                            device=cuda_device)
    lengths = rng.integers(0, 41, 20_000)
    bag_ids = np.repeat(np.arange(lengths.size), lengths)
    perm = rng.permutation(bag_ids.size)
    bags = torch.as_tensor(bag_ids[perm].astype(np.int32), device=cuda_device)
    flat = torch.as_tensor(rng.integers(0, 100_000, bag_ids.size), device=cuda_device)
    before = segment_sum_sorted.launches
    out = embedding_bag_segment(table, flat, bags, lengths.size)
    torch.cuda.synchronize()
    assert segment_sum_sorted.launches > before
    rows = table.double()[flat]
    exact = torch.zeros((lengths.size, 10), dtype=torch.float64, device=cuda_device)
    exact.index_add_(0, bags.long(), rows)
    scale = torch.zeros_like(exact).index_add_(0, bags.long(), rows.abs())
    assert out.dtype == torch.float32 and out.shape == (lengths.size, 10)
    assert bool(((out.double() - exact).abs() <= 1e-6 * scale).all())
    assert bool((out[torch.as_tensor(lengths == 0, device=cuda_device)] == 0).all())


# -- training ------------------------------------------------------------------------


@pytest.mark.cuda
def test_flash_entry_raises_under_grad_on_the_card(cuda_device):
    """The kernel has no backward: asked for a gradient, the entry raises
    before it launches; without grad it launches once."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((1, 256, 4, 64), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16).requires_grad_(True)
    k, v = (torch.randn((1, 256, 2, 64), generator=gen, device=cuda_device,
                        dtype=torch.bfloat16) for _ in range(2))
    before = flash_fwd.launches
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v, causal=True)
    assert flash_fwd.launches == before
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=True)
    assert flash_fwd.launches == before + 1 and out.grad_fn is None


def _mgn_batch(device, seed=0):
    from repro_torch.data.synthetic import graph_batch
    from repro_torch.launch.steps import build_bundle

    bundle = build_bundle("meshgraphnet", "minibatch_lg", reduced=True, device=device)
    batch = graph_batch(bundle.abstract_inputs, seed=seed, step=0,
                        n_nodes=bundle.abstract_inputs["x"].shape[0], device=device)
    return bundle, batch


@pytest.mark.cuda
def test_gnn_train_grads_through_the_kernel_match_float64(cuda_device):
    """MeshGraphNet's train loss (launch/steps.py's: masked log-likelihood
    over 64 classes) on a ``graph_batch`` batch: the kernel path's float32
    grads (every sum, and every gather's gradient, on the segment-sum
    kernel, counted in the backward) against the plain version run in
    float64 on the card, at rtol 1e-3 / atol 1e-5 as the PNA grads test."""
    bundle, batch = _mgn_batch(cuda_device)
    grads = {}
    for backend, dtype in (("cuda", torch.float32), ("torch", torch.float64)):
        model = bundle.init_state_fn(1)["params"].to(dtype)
        out = model(batch["x"].to(dtype), batch["edge_feat"].to(dtype), batch["edge_src"],
                    batch["edge_dst"], edge_mask=batch["edge_mask"], backend=backend)
        ll = torch.log_softmax(out, -1).gather(1, batch["labels"].long()[:, None])[:, 0]
        w = batch["label_mask"].to(dtype)
        loss = -(ll * w).sum() / w.sum().clamp(min=1.0)
        before = segment_sum_sorted.launches
        loss.backward()
        torch.cuda.synchronize()
        if backend == "cuda":
            assert segment_sum_sorted.launches > before  # the gathers' gradients
        grads[backend] = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads["cuda"].items():
        torch.testing.assert_close(g, grads["torch"][k].float(), rtol=1e-3, atol=1e-5, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("arch, shape", [("meshgraphnet", "minibatch_lg"),
                                         ("pna", "full_graph_sm")])
def test_gnn_train_restart_is_bit_exact_on_the_card(cuda_device, tmp_path, arch, shape):
    """8 steps straight against a crash at step 6 and a restart from the
    checkpoint at step 4: the same losses and the same final state, bit for
    bit (no gradient of the step adds by atomics)."""
    from repro_torch.launch.train import state_tree, train

    kw = dict(steps=8, ckpt_every=4, verbose=False, device=cuda_device)
    ref = train(arch, shape, ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(RuntimeError, match="injected crash"):
        train(arch, shape, ckpt_dir=str(tmp_path / "b"), crash_at=6, **kw)
    out = train(arch, shape, ckpt_dir=str(tmp_path / "b"), **kw)
    assert out["losses"] == ref["losses"][4:]

    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]

    a, b = dict(flat(state_tree(ref["final_state"]))), dict(flat(state_tree(out["final_state"])))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_lm_train_step_on_the_card_takes_the_plain_attention(cuda_device):
    """A reduced TinyLlama train step on the card: no flash launch (the
    kernel has no backward), every attention projection moved."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.steps import build_bundle

    bundle = build_bundle("tinyllama-1.1b", "train_4k", reduced=True, device=cuda_device)
    state = bundle.init_state_fn(0)
    before = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    batch = make_batch(bundle.abstract_inputs, seed=0, step=0, bounds=bundle.input_bounds,
                       device=cuda_device)
    launches = flash_fwd.launches
    state, m = bundle.step_fn(state, batch)
    torch.cuda.synchronize()
    assert flash_fwd.launches == launches and bool(torch.isfinite(m["loss"]))
    for n, p in state["params"].named_parameters():
        if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wo"):
            assert not torch.equal(p, before[n]), n


# -- the analysis layer on the card ----------------------------------------------


@pytest.mark.cuda
def test_audit_tree_on_the_card_is_clean(cuda_device):
    """Every program on both backends, dense and on 4 gloo ranks sharing
    the card (unmirrored and mirrored), the relayout sweep, the layout
    budgets and the delta cycle: no finding, and every window of the
    ``cuda`` backend launched the relax kernel, the later ones without a
    second ``row_ptr`` split."""
    from repro_torch.analysis.findings import render
    from repro_torch.analysis.trace_audit import AUDIT_WINDOWS, audit_tree

    summary = {}
    findings = audit_tree(device=cuda_device, summary=summary)
    assert not findings, render(findings)
    cuda_rows = [rows for key, rows in summary["dense"].items() if key.endswith("/cuda")]
    cuda_rows += [c["stats_rank0"] for c in summary["mesh"]["cases"] if "/cuda/" in c["label"]]
    assert len(cuda_rows) == 4 + 8
    for rows in cuda_rows:
        assert len(rows) == len(AUDIT_WINDOWS) and all(r["transfers"] == 7 for r in rows)
        assert all(r["inner_iters"] > 0 and r["launches"] > 0 for r in rows), rows
        assert all(r["partition_launches"] == 0 for r in rows[1:]), rows


@pytest.mark.cuda
def test_poisoned_output_check_passes_for_all_three_wrappers(cuda_device):
    """Relax (three instantiations), the segment sum (D = 1, 75) and flash
    (d = 128, 64) launched into the allocator's poisoned free blocks equal
    their plain versions; a wrapper that leaves rows unwritten is caught
    the same way."""
    from repro_torch.analysis.findings import render
    from repro_torch.analysis.fixtures import ALL_FIXTURES
    from repro_torch.analysis.trace_audit import audit_poisoned_kernels

    findings, rows = audit_poisoned_kernels(cuda_device)
    assert not findings, render(findings)
    assert len(rows) == 7 and all(r["landed"] and r["poisoned_bytes"] > 0 for r in rows)
    (skip,) = [fx for fx in ALL_FIXTURES if fx.rule == "AL03"]
    assert any("poisoned memory" in f.message for f in skip.run(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_extra_item_control_is_flagged_on_the_card(cuda_device, backend):
    from repro_torch.analysis.findings import render
    from repro_torch.analysis.trace_audit import control_extra_read, default_audit_graph

    findings = control_extra_read(default_audit_graph(), backend, device=cuda_device)
    assert [f.rule for f in findings] == ["JX01"], render(findings)
    assert "1 uncounted host read" in findings[0].message


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BUILTIN_PROGRAMS))
def test_sync_debug_count_equals_audited_reads_and_transfers(cuda_device, name):
    """The card's own count of synchronizing calls in a window equals the
    op log's host reads plus device-to-host transfers."""
    from repro_torch.analysis import trace_audit

    pg = trace_audit.default_audit_graph()
    engine = TraversalEngine(pg, program=BUILTIN_PROGRAMS[name](),
                             config=EngineConfig(device="cuda", backend="cuda", m_max=8))
    state = engine.init_state([0, 7, 33])
    torch.cuda.synchronize()
    (findings, stats, _), n = trace_audit.synchronizing_calls(
        lambda: trace_audit.audit_window(engine, state, 8, name))
    assert not findings
    assert n == stats["reads"] + stats["transfers"] and stats["transfers"] == 7


# -- data-parallel training on the card --------------------------------------------

#: D ranks against one rank, tests/test_torch_dp.py's bound on the CPU
DP_BOUND = dict(loss=1e-6, gnorm=1e-6)
DP_ARCHS = ["tinyllama-1.1b", "deepseek-v3-671b"]


def _dp_card_steps(arch: str, mesh=None) -> dict:
    """3 float32 steps of ``arch``'s reduced train bundle on the card, on
    ``mesh``'s data axis (this rank's rows) or on one rank."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.steps import build_bundle
    from repro_torch.launch.train import state_digests
    from repro_torch.optim import AdamWConfig, adamw_init

    tb = build_bundle(arch, "train_4k", reduced=True, device="cuda", mesh=mesh)
    model = tb.init_state_fn(0)["params"].to(torch.float32)
    state = {"params": model, "opt": adamw_init(model, AdamWConfig())}
    losses, gnorms = [], []
    for i in range(3):
        batch = make_batch(tb.abstract_inputs, seed=0, step=i, bounds=tb.input_bounds,
                           device="cuda")
        state, m = tb.step_fn(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    return {"losses": losses, "gnorms": gnorms, "digests": state_digests(state),
            "calls": None if mesh is None else mesh.data.stats.snapshot()["calls"]}


def _dp_card_rank(arch: str) -> dict:
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    return _dp_card_steps(arch, make_host_mesh())


def _assert_dp_equals_one_rank(ranks, arch):
    one = _dp_card_steps(arch)
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=DP_BOUND["loss"])
    np.testing.assert_allclose(got["gnorms"], one["gnorms"], rtol=DP_BOUND["gnorm"])
    assert all(r["digests"] == got["digests"] for r in ranks)
    assert got["calls"]["all_reduce"] >= 2 * 3  # a bucket and the loss, each step
    biases = [k for k in one["digests"] if k.endswith("router_bias")]
    assert bool(biases) == (arch == "deepseek-v3-671b")
    for k in biases:
        assert got["digests"][k] == one["digests"][k], k


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DP_ARCHS)
def test_data_parallel_on_one_card_matches_one_rank(cuda_device, arch):
    from repro_torch.dist import run_ranks

    if torch.cuda.device_count() >= 2:
        pytest.skip("each rank gets its own card here: the NCCL test covers it")
    ranks = run_ranks(_dp_card_rank, 2, device="cuda", timeout=600, args=(arch,))
    assert ranks.backend == "gloo" and ranks.devices == ["cuda:0", "cuda:0"]
    _assert_dp_equals_one_rank(ranks, arch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DP_ARCHS)
def test_nccl_data_parallel_on_two_cards_matches_one_rank(cuda_device, arch):
    from repro_torch.dist import run_ranks

    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs a card per rank; this machine has one")
    ranks = run_ranks(_dp_card_rank, 2, device="cuda", timeout=600, args=(arch,))
    assert ranks.backend == "nccl" and ranks.devices == ["cuda:0", "cuda:1"]
    _assert_dp_equals_one_rank(ranks, arch)


# -- the model axis on the card ----------------------------------------------------

#: the (1, 2) prefill's logits against one rank's, of their rms (tests/test_torch_tp.py)
TP_PREFILL_SHARE = 1e-5


def _tp_prefill_card(arch: str, mesh=None) -> dict:
    """A reduced LM's prefill in float32 on the card (on ``mesh``'s model
    axis, the rank's heads): the flash launches around the bundle's step,
    its next tokens and the last position's logits, whole."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch import steps
    from repro_torch.models.transformer import _logits, gather_logits, lm_hidden

    torch.backends.cuda.matmul.allow_tf32 = False
    tb = steps.build_bundle(arch, "prefill_32k", reduced=True, device="cuda", mesh=mesh)
    model = tb.init_state_fn(0)["params"].to(torch.float32)
    batch = make_batch(tb.abstract_inputs, seed=0, step=0, bounds=tb.input_bounds,
                       device="cuda")
    before = flash_fwd.launches
    out = tb.step_fn({"params": model}, batch)
    torch.cuda.synchronize()
    launches = flash_fwd.launches - before
    with torch.inference_mode():
        h, _, _ = lm_hidden(model, batch["tokens"], mesh=mesh)
        logits = gather_logits(model, _logits(model, h[:, -1:], mesh), mesh)[:, -1]
    return {"launches": launches, "next_token": out["next_token"].cpu(),
            "logits": logits.float().cpu(), "n_layers": model.cfg.n_layers,
            "heads": model.dense_layers[0].attn.wq.shape[1] if hasattr(model, "dense_layers")
            else model.moe_layers[0].attn.wq.shape[1]}


def _tp_prefill_card_rank(arch: str) -> dict:
    from repro_torch.launch.mesh import make_mesh

    return _tp_prefill_card(arch, make_mesh(data=1, model=2))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x22b"])
def test_model_axis_prefill_runs_the_flash_kernel_on_every_rank(cuda_device, arch):
    """Two ranks (gloo on one card, or NCCL on two) as a ``(1, 2)`` mesh:
    each rank holds half the heads and launches the flash kernel once a
    layer on them; the next tokens equal one rank's, the logits within
    ``TP_PREFILL_SHARE`` of their rms."""
    from repro_torch.dist import run_ranks

    ranks = run_ranks(_tp_prefill_card_rank, 2, device="cuda", timeout=600, args=(arch,))
    one = _tp_prefill_card(arch)
    assert one["launches"] == one["n_layers"]
    bound = TP_PREFILL_SHARE * float(one["logits"].square().mean().sqrt())
    for r in ranks:
        assert r["launches"] == r["n_layers"] == one["n_layers"]
        assert 2 * r["heads"] == one["heads"]
        assert torch.equal(r["next_token"], one["next_token"])
        assert float((r["logits"] - one["logits"]).abs().max()) <= bound


# -- split-KV decode on the card ------------------------------------------------------

#: the (1, 2) decode's logits against one rank's, of their rms (tests/test_torch_dryrun.py)
TP_DECODE_SHARE = 2e-5
TP_DECODE_STEPS, TP_DECODE_START = 6, 28


def _merge_without_rescale(axis, m, l, o):
    every = axis.all_gather(torch.cat([m[..., None], l[..., None], o], dim=-1))
    return every[..., 2:].sum(dim=0) / every[..., 1].sum(dim=0)[..., None]


def _decode_card(arch: str, mesh=None, control: bool = False) -> dict:
    """A reduced LM's decode in float32 on the card from a seeded cache of
    the reduced bundle's size (on ``mesh``: the rank's heads and its half
    of the slots), teacher-forced: each step's logits, whole vocab; the
    control merges the split-KV partials without their ``exp(m_j - M)``
    rescale (positions 28-33: the second rank's slots fill from 32)."""
    from repro_torch.dist.sharding import shard_of
    from repro_torch.launch import steps
    from repro_torch.models import attention
    from repro_torch.models.transformer import cache_spec, init_lm_cache, lm_decode_step

    torch.backends.cuda.matmul.allow_tf32 = False
    model = steps.build_bundle(arch, "prefill_32k", reduced=True, device="cuda",
                               mesh=mesh).init_state_fn(0)["params"].to(torch.float32)
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    cache = init_lm_cache(cfg, 2, 64, torch.float32, "cuda")
    for leaves in cache.values():
        for t in leaves.values():
            t.normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab, (2, TP_DECODE_STEPS), generator=gen, device="cuda")
    spec = None
    if mesh is not None:
        spec = cache_spec(cfg, 2, 64, mesh)
        cache = {k: {n: shard_of(t, tuple(spec) + (None,) * (t.dim() - 3), mesh).clone()
                     for n, t in v.items()} for k, v in cache.items()}
    real = attention._merge_partials
    attention._merge_partials = _merge_without_rescale if control else real
    logits = []
    try:
        with torch.inference_mode():
            for i in range(TP_DECODE_STEPS):
                lg, cache = lm_decode_step(model, cache, tokens[:, i:i + 1], TP_DECODE_START + i,
                                           mesh=mesh, cache_spec=spec)
                logits.append(lg[:, -1].float().cpu())
    finally:
        attention._merge_partials = real
    return {"logits": torch.stack(logits)}


def _decode_card_rank(arch: str) -> dict:
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(data=1, model=2)
    return {"main": _decode_card(arch, mesh), "control": _decode_card(arch, mesh, control=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b"])
def test_split_kv_decode_on_two_ranks_matches_one_rank(cuda_device, arch):
    """Two ranks (gloo on one card, or NCCL on two) as a ``(1, 2)`` mesh,
    each holding half the cache's slots: each step's logits within
    ``TP_DECODE_SHARE`` of one rank's rms; with the partials merged without
    their rescale they fall outside it."""
    from repro_torch.dist import run_ranks

    ranks = run_ranks(_decode_card_rank, 2, device="cuda", timeout=600, args=(arch,))
    one = _decode_card(arch)["logits"]
    bound = TP_DECODE_SHARE * float(one.square().mean().sqrt())
    for r in ranks:
        assert float((r["main"]["logits"] - one).abs().max()) <= bound
        assert float((r["control"]["logits"] - one).abs().max()) > bound
