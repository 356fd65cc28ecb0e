"""Port parity at the published configurations' shapes: the three LM
architectures whose distinguishing features ``reduced_config`` flattens,
each cut to a narrow width that keeps them, against the JAX package on the
CPU.

  * Mistral-NeMo-12B: ``d_model`` 80 with 4 heads of 16 (H * d_head = 64 is
    not d_model, as 32 x 128 = 4096 is not 5120), rope theta 1e6;
  * Granite-3-8B: an odd vocab (259; the published 49,155 is 3 mod 8) and
    d_ff 200 (12,800 / 4,096 = 200 / 64);
  * DeepSeek-V3: 4 layers, the first 3 dense, 256 routed experts top-8 at
    capacity 1.25 with 1 shared expert and the aux-free selection bias (set
    nonzero here, so it steers), MTP depth 1, the reduced MLA ranks.

The JAX package's parameters are carried across by
``convert.lm_params_from_numpy``; ``tests/test_torch_lm.py``'s tolerances
hold (``F32_ATOL`` on float32 logits and decode, ``LOSS_RTOL`` on losses,
``BF16_SHARE`` of the largest logit in bfloat16; loads and the kept
(token, k) pairs exactly).  Then the two repairs that the published widths
need on a card: ``init_dense`` scaling its draw in place, and MLA's chunked
prefill tiled by queries, skipping the key chunks above a tile's diagonal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro.models.moe as JM
import repro.models.transformer as JT
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models.transformer import init_lm_cache as jax_init_lm_cache
import repro_torch.models.attention as A
from repro_torch.configs import ARCHS
from repro_torch.configs.base import MLAConfig
from repro_torch.convert import _load_tree, lm_params_from_numpy
from repro_torch.models.common import init_dense
from repro_torch.models.moe import MoE, _capacity, _n_groups, moe_ffn, route
from repro_torch.models.transformer import (
    init_lm_cache,
    lm_decode_step,
    lm_forward,
    lm_loss_and_stats,
)

# the reference's functions, each compiled once a config (eager, DeepSeek-V3's
# 256 experts take minutes of the CPU's dispatch)
jax_init_lm_params = jax.jit(JT.init_lm_params, static_argnums=(1, 2))
jax_lm_forward = jax.jit(JT.lm_forward, static_argnums=(1,))
jax_lm_loss_and_stats = jax.jit(JT.lm_loss_and_stats, static_argnums=(1,))
jax_lm_decode_step = jax.jit(JT.lm_decode_step, static_argnums=(1,))
jax_moe_ffn = jax.jit(JM.moe_ffn, static_argnums=(1,))

F32_ATOL, LOSS_RTOL, BF16_SHARE = 1e-4, 1e-5, 0.05
KEY = jax.random.PRNGKey(0)
_MLA_RANKS = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16)

#: each architecture's narrow cut: every field not named here is the
#: published config's (MoE: only d_ff_expert narrows)
NARROW = {
    "mistral-nemo-12b": dict(n_layers=2, d_model=80, n_heads=4, n_kv_heads=2, d_head=16,
                             d_ff=224, vocab=256),
    "granite-3-8b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                         d_ff=200, vocab=259),
    "deepseek-v3-671b": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
                             d_ff=128, vocab=256, moe_d_ff_expert=8),
}
ARCH_IDS = list(NARROW)


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(vocab: int, shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _narrow(cfg, arch: str, mla_cls):
    kw = dict(NARROW[arch])
    d_ff_expert = kw.pop("moe_d_ff_expert", None)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, d_ff_expert=d_ff_expert)
    if cfg.mla is not None:
        kw["mla"] = mla_cls(**_MLA_RANKS)
    return dataclasses.replace(cfg, remat=False, **kw)


def _configs(arch: str):
    return (_narrow(JAX_ARCHS[arch].config, arch, JaxMLAConfig),
            _narrow(ARCHS[arch].config, arch, MLAConfig))


def test_narrow_configs_keep_the_published_features():
    """What each cut keeps, on both packages' configs alike."""
    for arch in ARCH_IDS:
        jcfg, cfg = _configs(arch)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        pub = ARCHS[arch].config
        for field in ("rope_theta", "first_k_dense", "mtp_depth", "sliding_window",
                      "tie_embeddings"):
            assert getattr(cfg, field) == getattr(pub, field), (arch, field)
    nemo, granite, ds = (_configs(a)[1] for a in ARCH_IDS)
    assert nemo.d_model != nemo.n_heads * nemo.d_head and nemo.rope_theta == 1e6
    assert granite.vocab % 2 == 1 and granite.vocab % 8 == ARCHS["granite-3-8b"].config.vocab % 8
    assert granite.d_ff / granite.d_model == ARCHS["granite-3-8b"].config.d_ff / 4096
    m = ds.moe
    assert (m.n_experts, m.top_k, m.n_shared, m.capacity_factor, m.aux_free_bias) == (
        256, 8, 1, 1.25, True)
    assert (ds.n_layers, ds.first_k_dense, ds.n_moe_layers, ds.mtp_depth) == (4, 3, 1, 1)


_MODELS: dict = {}


def _bf16(name: str, a):
    """A float32 leaf as ``init_lm_params(..., bfloat16)`` holds it: cast,
    but the router and its bias stay float32."""
    return a if name in ("router", "router_bias") else a.astype(jnp.bfloat16)


def _models(arch: str, dtype=jnp.float32):
    """The JAX config and parameters and the port's model holding them;
    DeepSeek-V3's selection bias drawn nonzero (built once a dtype: the
    bfloat16 tree is the float32 one cast, as ``init_lm_params`` casts its
    float32 draws)."""
    if (arch, dtype) not in _MODELS:
        jcfg, cfg = _configs(arch)
        if dtype == jnp.float32:
            params = jax_init_lm_params(KEY, jcfg, jnp.float32)
            if jcfg.moe is not None and jcfg.moe.aux_free_bias:
                bias = params["moe_layers"]["moe"]["router_bias"]
                params["moe_layers"]["moe"]["router_bias"] = jnp.asarray(
                    np.random.default_rng(1).standard_normal(bias.shape).astype(np.float32))
        else:
            params = jax.tree_util.tree_map_with_path(
                lambda path, a: _bf16(path[-1].key, a), _models(arch)[2])
        model = lm_params_from_numpy(numpy_tree(params), cfg, device="cpu")
        _MODELS[arch, dtype] = (jcfg, cfg, params, model)
    return _MODELS[arch, dtype]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_published_forward_matches_jax(arch):
    jcfg, cfg, params, model = _models(arch)
    toks = _tokens(cfg.vocab, (2, 16))
    j_logits, j_aux = jax_lm_forward(params, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        logits, aux = lm_forward(model, T(toks))
    assert logits.shape == (2, 16, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_published_forward_bf16_matches_jax(arch):
    jcfg, cfg, params, model = _models(arch, jnp.bfloat16)
    assert model.embed.dtype == torch.bfloat16
    toks = _tokens(cfg.vocab, (2, 16))
    j_logits = np.asarray(jax_lm_forward(params, jcfg, jnp.asarray(toks))[0].astype(jnp.float32))
    with torch.inference_mode():
        logits = lm_forward(model, T(toks))[0]
    err = np.abs(logits.float().numpy() - j_logits).max()
    assert err <= BF16_SHARE * np.abs(j_logits).max(), err


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_published_loss_and_moe_loads_match_jax(arch):
    """The next-token loss (DeepSeek-V3: plus the MTP term, its selection
    bias steering the routing) and every MoE layer's loads exactly."""
    jcfg, cfg, params, model = _models(arch)
    toks = _tokens(cfg.vocab, (2, 17), seed=1)
    j_loss, j_stats = jax_lm_loss_and_stats(params, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        loss, stats = lm_loss_and_stats(model, T(toks))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    if cfg.moe is None:
        assert stats["moe_loads"] is None and j_stats["moe_loads"] is None
        return
    loads = stats["moe_loads"].numpy()
    assert loads.shape == (cfg.n_moe_layers, 256)
    np.testing.assert_array_equal(loads, np.asarray(j_stats["moe_loads"]))
    np.testing.assert_allclose(loads.sum(-1), 1.0, atol=1e-6)
    # the MTP block counts: without it the loss moves
    if cfg.mtp_depth:
        model.cfg = dataclasses.replace(cfg, mtp_depth=0)
        try:
            with torch.inference_mode():
                bare = lm_loss_and_stats(model, T(toks))[0]
        finally:
            model.cfg = cfg
        assert abs(float(loss) - float(bare)) > 1e-3


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_published_decode_matches_jax_step_by_step(arch):
    """Each decode step's logits and every cache leaf (DeepSeek-V3: the
    latent and the rope key) against the JAX package's, 10 positions into
    a 12-slot cache."""
    jcfg, cfg, params, model = _models(arch)
    toks = _tokens(cfg.vocab, (2, 10), seed=2)
    j_cache = jax_init_lm_cache(jcfg, 2, 12, jnp.float32)
    cache = init_lm_cache(cfg, 2, 12, torch.float32, device="cpu")
    for pos in range(10):
        j_lg, j_cache = jax_lm_decode_step(params, jcfg, j_cache,
                                           jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos))
        with torch.inference_mode():
            lg, cache = lm_decode_step(model, cache, T(toks[:, pos:pos + 1]), pos)
        np.testing.assert_allclose(lg.numpy(), np.asarray(j_lg), atol=F32_ATOL, rtol=0)
    for key, leaves in cache.items():
        for name, t in leaves.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(j_cache[key][name]),
                                       atol=F32_ATOL, rtol=0, err_msg=f"{key}.{name}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_published_decode_matches_forward(arch):
    """A greedy-prefix replay through the decode path gives the forward's
    logits at every position (float32), on the port alone."""
    _, cfg, _, model = _models(arch)
    toks = T(_tokens(cfg.vocab, (1, 12), seed=3))
    cache = init_lm_cache(cfg, 1, 12, torch.float32, device="cpu")
    with torch.inference_mode():
        full = lm_forward(model, toks)[0]
        for pos in range(12):
            lg, cache = lm_decode_step(model, cache, toks[:, pos:pos + 1], pos)
            np.testing.assert_allclose(lg[0, 0].numpy(), full[0, pos].numpy(), atol=F32_ATOL,
                                       rtol=0, err_msg=str(pos))


# -- DeepSeek-V3's routing with drops --------------------------------------------------


def _jax_kept_pairs(params, cfg, x) -> np.ndarray:
    """``[T, K]`` bool: the reference's drop rule, run in JAX on its own
    routing (``tests/test_torch_lm.py``'s helper)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = JM._n_groups(t)
    t_loc = t // g
    cap = JM._capacity(t_loc, cfg)
    xg = x.reshape(g, t_loc, d)
    logits = jnp.einsum("gtd,de->gte", xg, params["router"].astype(xg.dtype),
                        preferred_element_type=jnp.float32)
    _, top_idx = jax.lax.top_k(logits + params.get("router_bias", 0.0), k)
    pair_expert = top_idx.reshape(g, t_loc * k)
    order = jnp.argsort(pair_expert, axis=1)
    se = jnp.take_along_axis(pair_expert, order, axis=1)
    starts = jax.vmap(lambda row: jnp.searchsorted(row, jnp.arange(e)))(se)
    pos_in_e = jnp.arange(t_loc * k)[None] - jnp.take_along_axis(starts, se, axis=1)
    keep_sorted = np.asarray(pos_in_e < cap)
    keep = np.zeros_like(keep_sorted)
    np.put_along_axis(keep, np.asarray(order), keep_sorted, axis=1)
    return keep.reshape(t, k)


def test_moe_ffn_drops_at_deepseek_v3_routing():
    """DeepSeek-V3's published routing (256 experts, top-8, capacity 1.25,
    a shared expert, the selection bias nonzero) over train_4k's 4,096
    tokens: 32 groups of 128 at capacity 8.  Some pairs drop, and the kept
    set equals the reference's exactly, as do the loads; y and aux within
    tolerance."""
    d = 16
    pub = ARCHS["deepseek-v3-671b"].config.moe
    cfg = dataclasses.replace(pub, d_ff_expert=8)
    jcfg = JaxMoEConfig(**dataclasses.asdict(cfg))
    params = JM.init_moe_params(jax.random.PRNGKey(11), d, jcfg, jnp.float32)
    params["router_bias"] = jnp.asarray(
        np.random.default_rng(11).standard_normal(256).astype(np.float32))
    x = np.random.default_rng(12).standard_normal((4096, d)).astype(np.float32)
    assert (_n_groups(4096), _capacity(128, cfg)) == (32, 8) == (
        JM._n_groups(4096), JM._capacity(128, jcfg))
    jy, jaux, jload = jax_moe_ffn(params, jcfg, jnp.asarray(x))
    p = MoE(d, cfg, dtype=torch.float32)
    _load_tree(p, numpy_tree(params))
    with torch.inference_mode():
        y, aux, load = moe_ffn(p, cfg, T(x))
        kept = route(p, cfg, T(x)).kept().numpy()
    assert kept.shape == (4096, 8) and not kept.all()
    np.testing.assert_array_equal(kept, _jax_kept_pairs(params, jcfg, jnp.asarray(x)))
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LOSS_RTOL)


# -- the two repairs ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_dense_in_place_equals_the_scaled_copy(dtype):
    """Scaling the draw in place gives the bits of ``(randn * scale).to``
    from the same generator state."""
    for d_in, d_out in ((7, 5), (64, 129), (300, 17)):
        got = init_dense(torch.Generator().manual_seed(d_in), d_in, d_out, dtype)
        w = torch.randn((d_in, d_out), generator=torch.Generator().manual_seed(d_in))
        want = (w * (1.0 / np.sqrt(d_in))).to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.fixture
def _restore_mla_tiling():
    saved = [(m, m.CHUNKED_ATTN_THRESHOLD, m._ATTN_CHUNK) for m in (A, JA)]
    tile = A._MLA_Q_TILE
    yield
    for m, thr, chunk in saved:
        m.CHUNKED_ATTN_THRESHOLD, m._ATTN_CHUNK = thr, chunk
    A._MLA_Q_TILE = tile


@pytest.mark.parametrize("tile", [32, 24])
def test_mla_query_tiles_equal_one_pass_and_jax(tile, _restore_mla_tiling, monkeypatch):
    """MLA's chunked prefill (chunks of 16 keys over S = 64, causal) with
    query tiles of ``tile`` rows equals the one-tile pass bit for bit, skips
    the chunks above each tile's diagonal, and stays within F32_ATOL of the
    reference's ``_mla_chunked``."""
    jcfg = dataclasses.replace(JAX_ARCHS["deepseek-v3-671b"].config, d_model=64, n_heads=4,
                               mla=JaxMLAConfig(**_MLA_RANKS))
    cfg = dataclasses.replace(ARCHS["deepseek-v3-671b"].config, d_model=64, n_heads=4,
                              mla=MLAConfig(**_MLA_RANKS))
    p = JA.init_mla_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = A.MLAAttention(cfg, dtype=torch.float32)
    _load_tree(tp, numpy_tree(p))
    x = np.random.default_rng(5).standard_normal((2, 64, 64)).astype(np.float32)
    for m in (A, JA):
        m.CHUNKED_ATTN_THRESHOLD, m._ATTN_CHUNK = 32, 16
    j = np.asarray(JA.mla_forward(p, jcfg, jnp.asarray(x)))
    calls = []
    step = A._chunk_step
    monkeypatch.setattr(A, "_chunk_step", lambda *a: calls.append(1) or step(*a))
    outs = {}
    for name, rows in (("one pass", 10**9), ("tiled", tile)):
        A._MLA_Q_TILE = rows
        calls.clear()
        with torch.inference_mode():
            outs[name] = A.mla_forward(tp, cfg, T(x))
        outs[name, "chunks"] = len(calls)
    # one pass: 4 chunks; tiles: each reads the chunks up to its last row
    tiles = [(i0, min(64, i0 + tile)) for i0 in range(0, 64, tile)]
    assert outs["one pass", "chunks"] == 4
    assert outs["tiled", "chunks"] == sum(-(-i1 // 16) for _, i1 in tiles) < 4 * len(tiles)
    assert torch.equal(outs["tiled"], outs["one pass"])
    np.testing.assert_allclose(outs["tiled"].numpy(), j, atol=F32_ATOL, rtol=0)
