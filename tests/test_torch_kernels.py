"""Port parity, segment-sum and flash-attention modules:
``repro_torch.kernels.{segment_sum,flash_attention}`` through their public
entry points on the CPU (the plain versions) against the JAX package's
Pallas kernels in interpret mode and its oracles, on every case of
``tests/test_kernels.py``, with inputs made from numpy seeds.

Tolerances are that file's: segment sum 1e-4 in float32 and 5e-2 in
bfloat16, attention 1e-5 in float32 and 2e-2 in bfloat16.

The TPU wrapper of flash attention lets zero-padded keys take softmax
weight when S is not a multiple of its block and the call is not causal;
there the port is held to ``reference_attention`` and not to the kernel.

The CUDA kernels themselves are held against their plain versions on the
card by ``tests/test_torch_cuda.py``; here a numpy replay of the segment-sum
kernel's carry levels checks the scheme itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.graph.structs as jax_structs
import repro.kernels.bfs_relax.ops as jax_relax_ops
from repro.analysis.fixtures import _legacy_block_dims
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import reference_attention as jax_ref_attention
from repro.kernels.segment_sum import reference_segment_sum as jax_ref_segment_sum
from repro.kernels.segment_sum import sorted_segment_sum as jax_segment_sum
from repro_torch.graph.structs import row_ptr_for
from repro_torch.kernels.bfs_relax import kernel as relax_kernel
from repro_torch.kernels.bfs_relax import ops as relax_ops
from repro_torch.kernels.bfs_relax.ref import relax_reference
from repro_torch.kernels.build import check_grid
from repro_torch.kernels.flash_attention import flash_attention, reference_attention
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.segment_sum import kernel as seg_kernel
from repro_torch.kernels.segment_sum import sorted_segment_sum

# ---------------------------------------------------------------------------
# segment sum
# ---------------------------------------------------------------------------

SEG_CASES = [
    # (E, D, N, dtype, skew), as in tests/test_kernels.py
    (1024, 64, 256, "float32", "uniform"),
    (2048, 128, 512, "float32", "powerlaw"),
    (777, 32, 100, "float32", "uniform"),
    (1024, 16, 64, "bfloat16", "uniform"),
    (4096, 75, 512, "float32", "powerlaw"),
    (512, 10, 1000, "float32", "uniform"),
]
SEG_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _ids(e, n, skew, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.5, e) % n if skew == "powerlaw" else rng.integers(0, n, e)
    return raw.astype(np.int32)


def _vals(e, d, seed):
    return np.random.default_rng(seed + 1).standard_normal((e, d)).astype(np.float32)


def _both(ids, vals, dtype):
    """The same inputs for both packages; bfloat16 rounds the same way."""
    jv = jnp.asarray(vals, getattr(jnp, dtype))
    tv = torch.as_tensor(vals).to(getattr(torch, dtype))
    return (jnp.asarray(ids), jv), (torch.as_tensor(ids), tv)


@pytest.mark.parametrize("case", SEG_CASES, ids=[f"{c[0]}x{c[1]}-{c[3]}-{c[4]}" for c in SEG_CASES])
def test_segment_sum_matches_jax(case):
    e, d, n, dtype, skew = case
    ids, vals = _ids(e, n, skew), _vals(e, d, seed=e)
    (jids, jvals), (tids, tvals) = _both(ids, vals, dtype)
    out = sorted_segment_sum(tids, tvals, n)
    assert out.dtype == torch.float32 and out.shape == (n, d)
    tol = SEG_TOL[dtype]
    for ref in (
        jax_segment_sum(jids, jvals, n, interpret=True),
        jax_ref_segment_sum(jids, jvals, n),
    ):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol, rtol=tol)


@given(
    e=st.integers(8, 600),
    n=st.integers(4, 300),
    d=st.sampled_from([4, 16, 33]),
    seed=st.integers(0, 10_000),
)
@settings(max_examples=20, deadline=None)
def test_segment_sum_property_matches_jax(e, n, d, seed):
    ids, vals = _ids(e, n, "uniform", seed), _vals(e, d, seed)
    out = sorted_segment_sum(torch.as_tensor(ids), torch.as_tensor(vals), n)
    ref = jax_segment_sum(jnp.asarray(ids), jnp.asarray(vals), n, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_segment_sum_no_edges_is_zero():
    ids, vals = np.zeros(0, np.int32), np.zeros((0, 12), np.float32)
    out = sorted_segment_sum(torch.as_tensor(ids), torch.as_tensor(vals), 9)
    ref = jax_segment_sum(jnp.asarray(ids), jnp.asarray(vals), 9, interpret=True)
    assert out.shape == (9, 12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), 0.0)


def test_segment_sum_drops_out_of_range_ids():
    n = 40
    ids = np.sort(np.random.default_rng(5).integers(-6, n + 6, 500)).astype(np.int32)
    vals = _vals(500, 8, seed=5)
    out = sorted_segment_sum(torch.as_tensor(ids), torch.as_tensor(vals), n, assume_sorted=True)
    ref = jax_ref_segment_sum(jnp.asarray(ids), jnp.asarray(vals), n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    kept = (ids >= 0) & (ids < n)
    np.testing.assert_allclose(
        out.numpy().sum(0), vals[kept].sum(0, dtype=np.float64), atol=1e-3
    )


def test_segment_sum_unsorted_ids_match_jax():
    ids = _ids(900, 70, "powerlaw", seed=3)
    np.random.default_rng(4).shuffle(ids)
    vals = _vals(900, 24, seed=3)
    out = sorted_segment_sum(torch.as_tensor(ids), torch.as_tensor(vals), 70, assume_sorted=False)
    ref = jax_segment_sum(jnp.asarray(ids), jnp.asarray(vals), 70, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def _replay_levels(ids, vals, n):
    """numpy replay of csrc/segment_sum.cu: each sub-chunk stores its
    inner runs, carries its first and last run, and the carries are
    reduced again until one sub-chunk is left."""
    sub = seg_kernel._SUB
    out = np.zeros((n, vals.shape[1]), np.float64)
    levels = seg_kernel.segment_levels(len(ids))
    for i, m in enumerate(levels):
        last = i == len(levels) - 1
        assert len(ids) == m
        c_ids, c_vals = [], []
        for lo in range(0, m, sub):
            hi = min(lo + sub, m)
            cuts = [lo, *(lo + np.flatnonzero(np.diff(ids[lo:hi])) + 1), hi]
            runs = [(ids[a], vals[a:b].sum(0)) for a, b in zip(cuts[:-1], cuts[1:])]
            if last:
                inner, carried = runs, []
            elif len(runs) == 1:
                inner, carried = [], [runs[0], (runs[0][0], np.zeros_like(runs[0][1]))]
            else:
                inner, carried = runs[1:-1], [runs[0], runs[-1]]
            for sid, total in inner:
                if 0 <= sid < n:
                    assert not out[sid].any(), "a segment was stored twice"
                    out[sid] = total
            c_ids += [c[0] for c in carried]
            c_vals += [c[1] for c in carried]
        if not last:
            assert len(c_ids) == levels[i + 1]
            ids, vals = np.asarray(c_ids), np.asarray(c_vals)
    return out


@pytest.mark.parametrize("e,n,skew", [(1, 5, "uniform"), (128, 7, "uniform"),
                                      (129, 300, "uniform"), (20000, 2000, "uniform"),
                                      (20000, 500, "powerlaw"), (40000, 3, "powerlaw")])
def test_segment_sum_carry_levels_replay(e, n, skew):
    ids = np.sort(_ids(e, n, skew, seed=e))
    vals = _vals(e, 3, seed=e).astype(np.float64)
    ref = sorted_segment_sum(torch.as_tensor(ids), torch.as_tensor(vals), n).numpy()
    np.testing.assert_allclose(_replay_levels(ids, vals, n), ref, atol=1e-4, rtol=1e-5)
    assert seg_kernel.segment_levels(e)[-1] <= seg_kernel._SUB


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (b, s, h, hk, d, window, dtype), as in tests/test_kernels.py
    (2, 256, 4, 2, 64, None, "float32"),
    (1, 128, 2, 2, 128, None, "float32"),
    (2, 256, 4, 4, 64, 64, "float32"),
    (1, 160, 2, 1, 48, None, "float32"),
    (1, 512, 8, 2, 64, 128, "float32"),
    (2, 256, 4, 2, 64, None, "bfloat16"),
    (1, 384, 6, 3, 96, None, "bfloat16"),
]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(b, s, h, hk, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))
    ]
    jax_side = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    torch_side = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays]
    return jax_side, torch_side


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize(
    "case", FLASH_CASES, ids=[f"s{c[1]}-h{c[2]}-hk{c[3]}-d{c[4]}-w{c[5]}-{c[6]}" for c in FLASH_CASES]
)
def test_flash_attention_matches_jax(case):
    b, s, h, hk, d, win, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, s, h, hk, d, dtype, seed=s + d)
    out = flash_attention(tq, tk, tv, window=win)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = FLASH_TOL[dtype]
    for ref in (
        jax_flash(jq, jk, jv, window=win, interpret=True),
        jax_ref_attention(jq, jk, jv, window=win),
    ):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=tol, rtol=tol)


def test_flash_attention_noncausal_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 128, 2, 2, 64, "float32", seed=7)
    out = flash_attention(tq, tk, tv, causal=False)
    ref = jax_flash(jq, jk, jv, causal=False, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=1e-5, rtol=1e-5)


def test_flash_attention_matches_jax_at_every_block_size():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 256, 2, 2, 64, "float32", seed=11)
    out = _f32(flash_attention(tq, tk, tv))
    for bq, bk in [(64, 64), (128, 64), (64, 128), (256, 256)]:
        ref = jax_flash(jq, jk, jv, block_q=bq, block_k=bk, interpret=True)
        np.testing.assert_allclose(out, _f32(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s,h,hk,window", [(160, 2, 1, None), (200, 2, 1, 64), (200, 4, 2, None)])
def test_flash_attention_ragged_noncausal_matches_reference(s, h, hk, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, s, h, hk, 64, "float32", seed=s)
    out = flash_attention(tq, tk, tv, causal=False, window=window)
    ref = jax_ref_attention(jq, jk, jv, causal=False, window=window)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 200), (True, 65), (False, 100)])
def test_bf16_bound_holds_the_jax_kernel_and_refuses_a_short_window(causal, window):
    """The scaled bfloat16 bound the card's checks use: the JAX kernel's
    bfloat16 output (interpret mode) passes it, and the plain version with
    a window one 64-key tile short does not."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 333, 4, 2, 64, "bfloat16", seed=window)
    exact = flash_ref.attention_rows(tq, tk, tv, 0, 333, causal=causal, window=window)
    jax_out = torch.as_tensor(
        _f32(jax_flash(jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64,
                       interpret=True))).to(torch.bfloat16)
    short = flash_attention(tq, tk, tv, causal=causal, window=window - 64)
    if causal:  # the TPU wrapper is right only where it masks its padded keys
        assert flash_ref.bf16_tolerance_ratio(jax_out, exact) <= 1.0
    assert flash_ref.bf16_tolerance_ratio(flash_attention(tq, tk, tv, causal=causal,
                                                          window=window), exact) <= 1.0
    assert flash_ref.bf16_tolerance_ratio(short, exact) > 1.0


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, 40)])
def test_reference_attention_chunks_agree_with_one_pass(monkeypatch, causal, window):
    _, (tq, tk, tv) = _qkv(2, 200, 4, 2, 32, "float32", seed=3)
    whole = reference_attention(tq, tk, tv, causal=causal, window=window)
    monkeypatch.setattr(flash_ref, "MAX_SCORES", 2 * 4 * 200 * 7)  # 7-row chunks
    chunked = reference_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6, rtol=1e-6)


def _replay_flash_tiles(q, k, v, causal, window, bq, bk, half=None, mask_past_s=True):
    """numpy replay of csrc/flash_attention.cu's loop: per query tile, the
    key tiles ``key_tile_range`` visits, the mask skipped where the
    ``full`` predicate holds, and the streaming softmax in log2 units.
    ``half`` splits each query tile into row groups that share its key
    tiles and decide ``full`` on their own rows (the wgmma kernel's two
    consumer warpgroups of 64 rows).  Key tiles past S are zero-filled, as
    TMA fills them; ``mask_past_s=False`` leaves those keys unmasked."""
    b, s, h, d = q.shape
    half = half or bq
    g = h // k.shape[2]
    out = np.zeros(q.shape, np.float64)
    sl2 = np.log2(np.e) / np.sqrt(d)
    for q0 in range(0, s, bq):
        k_lo = max(0, q0 - window + 1) if window else 0
        k_hi = min(s, q0 + bq) if causal else s
        t_lo, t_hi = k_lo // bk, (-(-k_hi // bk) if k_hi > k_lo else k_lo // bk)
        for qa in range(q0, q0 + bq, half):
            rows = np.arange(qa, qa + half)
            for hh in range(h):
                qt = np.zeros((b, half, d))
                qt[:, : max(0, min(half, s - qa))] = q[:, qa : qa + half, hh]
                m = np.full((b, half), -np.inf)
                l = np.zeros((b, half))
                acc = np.zeros((b, half, d))
                for kt in range(t_lo, t_hi):
                    k0 = kt * bk
                    kk = np.zeros((b, bk, d))
                    vv = np.zeros((b, bk, d))
                    kk[:, : min(bk, s - k0)] = k[:, k0 : k0 + bk, hh // g]
                    vv[:, : min(bk, s - k0)] = v[:, k0 : k0 + bk, hh // g]
                    sc = np.einsum("bqd,bkd->bqk", qt, kk) * sl2
                    full = ((k0 + bk <= s or not mask_past_s)
                            and (not causal or k0 + bk - 1 <= qa)
                            and (not window or k0 > qa + half - 1 - window))
                    if not full:
                        cols = np.arange(k0, k0 + bk)[None, :]
                        keep = cols < s if mask_past_s else np.ones_like(cols, bool)
                        if causal:
                            keep = keep & (cols <= rows[:, None])
                        if window:
                            keep = keep & (cols > rows[:, None] - window)
                        sc = np.where(keep[None], sc, -np.inf)
                    m_new = np.maximum(m, sc.max(-1))
                    m_use = np.where(np.isneginf(m_new), 0.0, m_new)
                    p = np.exp2(sc - m_use[..., None])
                    corr = np.exp2(m - m_use)
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + np.einsum("bqk,bkd->bqd", p, vv)
                    m = m_new
                n_rows = max(0, min(half, s - qa))
                inv = np.where(l > 0, 1.0 / np.where(l > 0, l, 1.0), 0.0)  # rows past S
                out[:, qa : qa + n_rows, hh] = (acc * inv[..., None])[:, :n_rows]
    return out


@pytest.mark.parametrize("bq,bk", [(64, 64), (32, 32)])
@pytest.mark.parametrize("s,causal,window", [(200, True, None), (200, True, 48),
                                             (200, False, 64), (160, False, None),
                                             (256, True, 128)])
def test_flash_kernel_tile_loop_replay(bq, bk, s, causal, window):
    _, (tq, tk, tv) = _qkv(1, s, 4, 2, 16, "float32", seed=s)
    ref = reference_attention(tq, tk, tv, causal=causal, window=window).numpy()
    rep = _replay_flash_tiles(*(t.numpy().astype(np.float64) for t in (tq, tk, tv)),
                              causal, window, bq, bk)
    np.testing.assert_allclose(rep, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s,causal,window", [(200, True, None), (300, False, None),
                                             (333, True, 100), (130, False, 50),
                                             (256, True, None), (1, True, None)])
def test_flash_wgmma_tile_loop_replay(s, causal, window):
    """The wgmma kernel's tiling: 128-query tiles as two 64-row halves,
    128-key tiles, masks only on the tiles a half's rows cut, keys at or
    past S masked."""
    _, (tq, tk, tv) = _qkv(1, s, 4, 2, 16, "float32", seed=s + 1)
    ref = reference_attention(tq, tk, tv, causal=causal, window=window).numpy()
    args = [t.numpy().astype(np.float64) for t in (tq, tk, tv)]
    rep = _replay_flash_tiles(*args, causal, window, 128, 128, half=64)
    np.testing.assert_allclose(rep, ref, atol=1e-5, rtol=1e-5)
    if not causal and s % 128:  # TMA's zero-filled keys past S, left unmasked, take weight
        bad = _replay_flash_tiles(*args, causal, window, 128, 128, half=64, mask_past_s=False)
        assert np.abs(bad - ref).max() > 1e-2


def test_flash_variant_is_chosen_by_shape():
    vf = flash_kernel.variant_for
    assert vf(128, torch.bfloat16, True) == "bfloat16-wgmma"
    assert vf(40, torch.bfloat16, True) == "bfloat16-wgmma"
    assert vf(33, torch.bfloat16, True) == "bfloat16-mma"
    assert vf(128, torch.bfloat16, False) == "bfloat16-mma"
    assert vf(128, torch.float32, True) == "float32"
    assert flash_kernel.launch_grid(1, 300, 4, "bfloat16-wgmma") == (3, 4, 1)
    assert flash_kernel.launch_grid(1, 300, 4, "bfloat16-mma") == (5, 4, 1)


def test_flash_attention_rejects_bad_shapes():
    _, (tq, tk, tv) = _qkv(1, 32, 3, 2, 16, "float32")
    with pytest.raises(ValueError, match="do not share"):
        flash_attention(tq, tk, tv)
    _, (tq, tk, tv) = _qkv(1, 32, 2, 1, 16, "float32")
    with pytest.raises(ValueError, match="window"):
        flash_attention(tq, tk, tv, window=0)


# ---------------------------------------------------------------------------
# backends, wrappers and the launch-grid check
# ---------------------------------------------------------------------------


def test_cuda_backend_on_cpu_tensors_raises():
    ids, vals = torch.zeros(4, dtype=torch.int32), torch.ones(4, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        sorted_segment_sum(ids, vals, 2, backend="cuda")
    _, (tq, tk, tv) = _qkv(1, 16, 2, 1, 8, "float32")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(tq, tk, tv, backend="cuda")


def test_kernel_wrappers_refuse_cpu_tensors_without_building(tmp_path):
    seg = seg_kernel.SegmentSumKernel(build_dir=tmp_path / "seg")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        seg(torch.zeros(4, dtype=torch.int32), torch.ones(4, 3), 2)
    fl = flash_kernel.FlashAttentionKernel(build_dir=tmp_path / "flash")
    _, (tq, tk, tv) = _qkv(1, 16, 2, 1, 8, "float32")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fl(tq, tk, tv, causal=True, window=None)
    assert seg.launches == fl.launches == 0 and not list(tmp_path.iterdir())


def test_grid_check_refuses_the_legacy_zero_size_grid():
    """The intent of the analyzer's zero-size-grid fixture: the legacy
    block dims of an empty edge shard (16 vertices, 0 edges) give an inner
    grid dimension of 0, and the launch-grid check refuses it."""
    bn, be, n_pad, e_pad = _legacy_block_dims(16, 0, 512, 512)
    grid = (n_pad // bn, e_pad // be if be else 0)
    assert grid == (1, 0)
    with pytest.raises(ValueError, match="zero dimension"):
        check_grid(grid, "legacy relax")
    check_grid((1, 1), "one block")


@pytest.mark.parametrize("e,d", [(1, 1), (1, 10), (128, 33), (129, 75), (61_859_140, 128)])
def test_wrapper_grids_are_never_empty(e, d):
    for m in seg_kernel.segment_levels(e):
        for vec in (1, 4):
            check_grid(seg_kernel.launch_grid(m, d, vec), "segment sum")
    for variant in flash_kernel.VARIANTS:
        check_grid(flash_kernel.launch_grid(1, min(e, 40_000), 48, variant), "flash")


# ---------------------------------------------------------------------------
# relax: the merge-path partition and the fix-up of cut rows
# ---------------------------------------------------------------------------


def _merge_search(diag, rows, edges, e_lo, ends):
    """csrc/relax.cu's ``merge_search``: the row ends among the first
    ``diag`` items of the merge of ``ends`` with ``e_lo + arange(edges)``."""
    lo, hi = max(0, diag - edges), min(diag, rows)
    while lo < hi:
        mid = (lo + hi) // 2
        if ends[mid] <= e_lo + diag - mid - 1:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _replay_relax(row_ptr, cand, base, reduce, threads, items):
    """numpy replay of csrc/relax.cu: tile starts by merge path, each
    thread's walk over its items, the segmented scan of the threads'
    partials, head and tail partials of cut rows, and the fix-up.  Returns
    the output and, per row, the tiles its edges span."""
    tile = threads * items
    n = len(row_ptr) - 1
    s_count, e = cand.shape
    acc_dt = np.float64 if reduce == "sum" and base.dtype == np.float32 else base.dtype.type
    comb = np.minimum if reduce == "min" else np.add
    ident = relax_ops._identity_scalar(reduce, acc_dt)
    tiles = -(-(n + e) // tile)
    starts = []
    for t in range(tiles + 1):
        d = min(t * tile, n + e)
        i = _merge_search(d, n, e, 0, row_ptr[1:])
        starts.append((i, d - i))
    out = np.zeros_like(base)
    writes = np.zeros(base.shape, np.int64)
    head = np.full((s_count, tiles), ident, acc_dt)
    tail = np.full((s_count, tiles), ident, acc_dt)
    spans = {}
    for b in range(tiles):
        (i0, j0), (i1, j1) = starts[b], starts[b + 1]
        nr, ne = i1 - i0, j1 - j0
        ends = row_ptr[i0 + 1 : i1 + 1]
        cut = nr > 0 and row_ptr[i0] < j0
        walks = []
        for t in range(threads):
            d0 = min(t * items, nr + ne)
            d1 = min(d0 + items, nr + ne)
            ti0 = _merge_search(d0, nr, ne, j0, ends)
            walks.append((d0, d1, ti0, d0 - ti0))
        for s in range(s_count):
            c = cand[s, j0:j1].astype(acc_dt)

            def walk(d0, d1, ti, tj, a, emit):
                flag = False
                for _ in range(d0, d1):
                    if ti < nr and ends[ti] <= j0 + tj:
                        emit(ti, a)
                        flag, a, ti = True, ident, ti + 1
                    else:
                        a, tj = comb(a, c[tj]), tj + 1
                return flag, a

            parts = [walk(*w, ident, lambda ti, a: None) for w in walks]
            scan, run = [], ident
            for flag, a in parts:
                run = a if flag else comb(run, a)
                scan.append(run)

            def emit(ti, a, s=s, b=b):
                if ti == 0 and cut:
                    head[s, b] = a
                else:
                    r = i0 + ti
                    out[s, r] = comb(acc_dt(base[s, r]), a)
                    writes[s, r] += 1

            for t, w in enumerate(walks):
                walk(*w, scan[t - 1] if t else ident, emit)
            if i1 < n:
                tail[s, b] = scan[-1]
        if cut:
            r = i0
            first = (r + row_ptr[r]) // tile
            spans[r] = b - first + 1
            for s in range(s_count):
                acc = ident
                for k in range(first, b):
                    acc = comb(acc, tail[s, k])
                out[s, r] = comb(comb(acc_dt(base[s, r]), acc), head[s, b])
                writes[s, r] += 1
    assert (writes == 1).all(), "a row was written twice or never"
    return out.astype(base.dtype), spans


def _relax_inputs(n, e, reduce, dtype, seed, hub=None, s=2):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, e)
    if hub is not None:  # vertex, in-edges
        dst = np.concatenate([dst, np.full(hub[1], hub[0])])
    dst = np.sort(dst).astype(np.int32)
    e = len(dst)
    ident = relax_ops._identity_scalar(reduce, dtype)
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


RELAX_REPLAY = {
    # name: (n, e, hub (vertex, in-edges) or None, threads, items)
    "cut_rows": (50, 300, None, 4, 4),
    "hub_3_tiles": (20, 40, (7, 100), 4, 4),
    "zero_degree_at_boundary": (200, 30, None, 4, 4),
    "e0": (37, 0, None, 4, 4),
    "n_lt_8": (5, 9, None, 4, 4),
    "single_edge": (40, 1, None, 4, 4),
    "kernel_tile_hub": (3000, 20000, (1234, 6000), 128, 16),  # csrc/relax.cu's tiling
}
RELAX_VARIANTS = [("min", np.float32), ("min", np.int32), ("sum", np.float32)]


@pytest.mark.parametrize("variant", RELAX_VARIANTS, ids=["min-f32", "min-i32", "sum-f32"])
@pytest.mark.parametrize("name", sorted(RELAX_REPLAY))
def test_relax_merge_path_replay(name, variant):
    """The kernel's partition and fix-up replayed in numpy, against the
    plain version and (at small sizes) the JAX kernel in interpret mode:
    min bit-exact, sum within rtol=1e-5, atol=1e-9."""
    reduce, dtype = variant
    n, e, hub, threads, items = RELAX_REPLAY[name]
    dst, cand, base = _relax_inputs(n, e, reduce, dtype, seed=n + e, hub=hub)
    row_ptr = row_ptr_for(dst, n)
    rep, spans = _replay_relax(row_ptr, cand, base, reduce, threads, items)
    assert rep.dtype == base.dtype
    tile = threads * items
    if name == "kernel_tile_hub":
        assert tile == relax_kernel.TILE_ITEMS
    if name == "hub_3_tiles" or name == "kernel_tile_hub":
        assert spans[hub[0]] >= 3, spans
    if name == "cut_rows":
        assert len(spans) >= 3
    if name == "zero_degree_at_boundary":  # a tile starts on a row with no edges
        assert any(
            row_ptr[_merge_search(d, n, len(dst), 0, row_ptr[1:])]
            == row_ptr[_merge_search(d, n, len(dst), 0, row_ptr[1:]) + 1]
            for d in range(tile, n + len(dst), tile)
        )
    ref = relax_reference(
        torch.as_tensor(dst.astype(np.int64)), torch.as_tensor(cand), torch.as_tensor(base), reduce
    ).numpy()
    refs = [ref]
    if tile == 16:
        refs.append(np.asarray(_jax_relax_blockmap(dst, cand, base, reduce)))
    for r in refs:
        if reduce == "min":
            np.testing.assert_array_equal(rep, r)
        else:
            np.testing.assert_allclose(rep, r, rtol=1e-5, atol=1e-9)


def _jax_relax_blockmap(dst, cand, base, reduce):
    s, e = cand.shape
    n = base.shape[1]
    bn, be, _, _ = jax_relax_ops._block_dims(n, e, 64, 64)
    start, cnt, t_max = jax_structs.block_ranges_for(dst, n, bn, be)
    return jax_relax_ops.relax_blockmap_call(
        jnp.asarray(start), jnp.asarray(cnt), jnp.asarray(dst),
        jnp.asarray(cand), jnp.asarray(base), reduce=reduce,
        block_n=bn, block_e=be, t_max=t_max, interpret=True,
    )


@pytest.mark.parametrize("s,n,e", [(1, 1, 0), (4, 5, 9), (4, 4_194_304, 28_064_538),
                                   (1, 4_194_304, 41_558_636)])
def test_relax_wrapper_grids_are_never_empty(s, n, e):
    for grid in relax_kernel.launch_grids(s, n, e):
        check_grid(grid, "relax")
    assert relax_kernel.tile_count(n, e) * relax_kernel.TILE_ITEMS >= n + e
