"""Port parity, relax kernel module: ``repro_torch.kernels.bfs_relax`` on
the ``torch`` backend against the JAX package's Pallas kernels in interpret
mode, for min/float32, min/int32 and sum/float32, including the degenerate
``e == 0``, ``n < 8`` and single-edge shapes.

Tolerance: min is exact; sum is ``rtol=1e-5, atol=1e-9`` (float sums
reassociate), the bound ``tests/test_traversal_engine.py`` already uses.

The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph.program as jprog
import repro.graph.structs as jstructs
import repro.kernels.bfs_relax.ops as jops
import repro_torch.graph.program as tprog
import repro_torch.graph.structs as tstructs
import repro_torch.kernels.bfs_relax.ops as tops
from repro_torch.kernels.bfs_relax.kernel import SOURCE as SOURCE_FOR_BUILD
from repro_torch.kernels.bfs_relax.kernel import KernelBuildError, RelaxKernel
from repro_torch.kernels.bfs_relax.ref import reference_bfs_relax

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


def _inputs(s, n, e, reduce, dtype, seed):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    ident = tops._identity_scalar(reduce, dtype)
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
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if reduce == "min":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-9)


def _jax_blockmap(dst, cand, base, reduce):
    s, e = cand.shape
    n = base.shape[1]
    bn, be, _, _ = jops._block_dims(n, e, 64, 64)
    start, cnt, t_max = jstructs.block_ranges_for(dst, n, bn, be)
    return jops.relax_blockmap_call(
        jnp.asarray(start), jnp.asarray(cnt), jnp.asarray(dst),
        jnp.asarray(cand), jnp.asarray(base), reduce=reduce,
        block_n=bn, block_e=be, t_max=t_max, interpret=True,
    )


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_relax_blockmap_call_matches_pallas_interpret(shape, variant):
    reduce, dtype = variant
    s, n, e = SHAPES[shape]
    dst, cand, base = _inputs(s, n, e, reduce, dtype, seed=s * 1000 + n + e)
    row_ptr = torch.as_tensor(tstructs.row_ptr_for(dst, n))
    out = tops.relax_blockmap_call(
        row_ptr, torch.as_tensor(dst.astype(np.int64)), torch.as_tensor(cand),
        torch.as_tensor(base), reduce=reduce,
    )
    _assert_close(out.numpy(), _jax_blockmap(dst, cand, base, reduce), reduce)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_make_relax_fn_matches_pallas_interpret(shape, variant):
    reduce, dtype = variant
    s, n, e = SHAPES[shape]
    dst, cand, base = _inputs(s, n, e, reduce, dtype, seed=7 * n + e)
    src = np.zeros(e, np.int32)
    layout = tstructs.CsrEdgeLayout(n, src, dst, np.ones(e, np.float32))
    fn = tops.make_relax_fn(layout, reduce=reduce, device="cpu")
    out = fn(torch.as_tensor(cand), torch.as_tensor(base))
    jfn = jops.make_relax_fn(
        dst, n, reduce=reduce, block_n=64, block_e=64, interpret=True
    )
    _assert_close(out.numpy(), jfn(jnp.asarray(cand), jnp.asarray(base)), reduce)


def _random_edges(n, e, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.uniform(0.5, 2.0, e).astype(np.float32)
    return rng, src, dst, w


@pytest.mark.parametrize("shape", ["ragged", "n_lt_8", "single_edge", "e0"])
def test_bfs_relax_csr_matches_pallas_interpret(shape):
    s, n, e = SHAPES[shape]
    rng, src, dst, w = _random_edges(n, e, seed=n + 3 * e)
    dist = np.where(
        rng.random((s, n)) < 0.5, rng.uniform(0, 10, (s, n)), np.inf
    ).astype(np.float32)
    frontier = rng.random((s, n)) < 0.4
    jl = jstructs.dst_sorted_layout(n, src, dst, w)
    tl = tstructs.dst_sorted_layout(n, src, dst, w)
    ref = jops.bfs_relax_csr(
        jnp.asarray(dist), jnp.asarray(frontier), jl,
        block_n=64, block_e=64, interpret=True,
    )
    out = tops.bfs_relax_csr(torch.as_tensor(dist), torch.as_tensor(frontier), tl)
    _assert_close(out.numpy(), ref, "min")
    out1 = tops.bfs_relax_csr(
        torch.as_tensor(dist[0]), torch.as_tensor(frontier[0]), tl
    )
    _assert_close(out1.numpy(), np.asarray(ref)[0], "min")


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("shape", ["ragged", "n_lt_8", "single_edge"])
def test_bfs_relax_matches_pallas_interpret(shape, presorted):
    _, n, e = SHAPES[shape]
    rng, src, dst, w = _random_edges(n, e, seed=5 * n + e)
    if presorted:
        lay = jstructs.dst_sorted_layout(n, src, dst, w)
        src, dst, w = lay.src, lay.dst, lay.weights
    dist = np.where(rng.random(n) < 0.5, rng.uniform(0, 10, n), np.inf).astype(
        np.float32
    )
    frontier = rng.random(n) < 0.4
    args = (dist, frontier, src, dst, w)
    ref = jops.bfs_relax(
        *(jnp.asarray(a) for a in args), block_n=64, block_e=64,
        interpret=True, presorted=presorted,
    )
    out = tops.bfs_relax(*(torch.as_tensor(a) for a in args), presorted=presorted)
    _assert_close(out.numpy(), ref, "min")
    oracle = reference_bfs_relax(*(torch.as_tensor(a) for a in args))
    _assert_close(oracle.numpy(), ref, "min")


@pytest.mark.parametrize("name", sorted(tprog.BUILTIN_PROGRAMS))
def test_relax_csr_matches_pallas_interpret(name):
    s, n, e = SHAPES["ragged"]
    rng, src, dst, w = _random_edges(n, e, seed=11)
    tp, jp = tprog.BUILTIN_PROGRAMS[name](), jprog.BUILTIN_PROGRAMS[name]()
    if np.dtype(tp.dtype) == np.int32:
        state = rng.integers(0, n, (s, n)).astype(np.int32)
    else:
        state = np.where(
            rng.random((s, n)) < 0.5, rng.uniform(0, 1, (s, n)), tp.identity
        ).astype(np.float32)
    frontier = rng.random((s, n)) < 0.4
    jl = jstructs.dst_sorted_layout(n, src, dst, w)
    tl = tstructs.dst_sorted_layout(n, src, dst, w)
    ref = jops.relax_csr(
        jp, jnp.asarray(state), jnp.asarray(frontier), jl,
        block_n=64, block_e=64, interpret=True,
    )
    out = tops.relax_csr(tp, torch.as_tensor(state), torch.as_tensor(frontier), tl)
    _assert_close(out.numpy(), ref, tp.reduce)


@pytest.mark.parametrize("geometry", [(8, 8), (64, 64), (16, 128), (512, 512)])
def test_row_ptr_agrees_with_block_map_spans(geometry):
    """Every edge of a row block lies in the block map's edge-block span,
    and a non-empty row block's span is exactly the one its ``row_ptr``
    edges occupy."""
    bn, be = geometry
    n, e = 257, 1023
    dst = np.sort(np.random.default_rng(4).integers(0, n, e)).astype(np.int32)
    rp = tstructs.row_ptr_for(dst, n)
    assert rp.dtype == np.int32 and rp.shape == (n + 1,)
    assert rp[0] == 0 and rp[-1] == e and (np.diff(rp) >= 0).all()
    np.testing.assert_array_equal(np.repeat(np.arange(n), np.diff(rp)), dst)
    start, cnt, _ = jstructs.block_ranges_for(dst, n, bn, be)
    for ob in range(start.shape[0]):
        lo, hi = int(rp[ob * bn]), int(rp[min((ob + 1) * bn, n)])
        if hi > lo:
            assert start[ob] == lo // be
            assert cnt[ob] == (hi - 1) // be - lo // be + 1
        else:
            assert cnt[ob] <= 1  # at most one edge block straddles the gap


def test_backend_resolution_and_cuda_on_cpu_raises():
    assert tops.validate_backend(None, "cpu") == "torch"
    assert tops.validate_backend("torch", "cpu") == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        tops.validate_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        tops.validate_backend("emulate", "cpu")
    dst, cand, base = _inputs(2, 20, 30, "min", np.float32, seed=0)
    with pytest.raises(ValueError, match="CUDA device"):
        tops.relax_blockmap_call(
            None, torch.as_tensor(dst.astype(np.int64)), torch.as_tensor(cand),
            torch.as_tensor(base), reduce="min", backend="cuda",
        )


def test_kernel_wrapper_refuses_cpu_tensors_without_building(tmp_path):
    kern = RelaxKernel(build_dir=tmp_path)
    dst, cand, base = _inputs(2, 20, 30, "min", np.float32, seed=1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kern(
            torch.as_tensor(tstructs.row_ptr_for(dst, 20)), torch.as_tensor(cand),
            torch.as_tensor(base), reduce="min",
        )
    assert kern.launches == 0 and not list(tmp_path.iterdir())


def test_missing_nvcc_raises(tmp_path):
    kern = RelaxKernel(build_dir=tmp_path / "build")
    with pytest.raises(KernelBuildError, match="nvcc not found"):
        kern.load(nvcc=str(tmp_path / "no-such-nvcc"))
    assert kern.launches == 0 and kern.build_seconds is None


def test_refused_build_raises(tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'relax.cu(1): error: refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    kern = RelaxKernel(build_dir=tmp_path / "build")
    with pytest.raises(KernelBuildError, match="refused"):
        kern.load(nvcc=str(fake))
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(KernelBuildError):  # no cached half-state: fails again
        kern.load(nvcc=str(fake))


def test_build_defines_reach_nvcc_and_name_their_own_library(tmp_path):
    """A diagnosis build (``-DRELAX_PHASE_CLOCKS``) gets its own library
    name, so it never loads in place of the default build."""
    from repro_torch.kernels.build import build_library

    fake = tmp_path / "nvcc"
    fake.write_text(
        '#!/bin/sh\necho "$@" > "$(dirname "$0")/args.txt"\n'
        'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n'
    )
    fake.chmod(0o755)
    plain, _ = build_library(SOURCE_FOR_BUILD, tmp_path / "b", nvcc=str(fake))
    assert "-DRELAX_PHASE_CLOCKS" not in (tmp_path / "args.txt").read_text()
    clocked, _ = build_library(
        SOURCE_FOR_BUILD, tmp_path / "b", nvcc=str(fake), defines=("RELAX_PHASE_CLOCKS",)
    )
    assert "-DRELAX_PHASE_CLOCKS" in (tmp_path / "args.txt").read_text().split()
    assert plain != clocked and plain.exists() and clocked.exists()
