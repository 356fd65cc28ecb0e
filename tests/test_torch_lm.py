"""Port parity, the LM stack: ``repro_torch.models.{attention,moe,transformer}``,
the parameter rule tables of ``repro_torch.dist.sharding``,
``convert.lm_params_from_numpy``, the LM bundles of ``launch.steps`` and
``launch.serve``, against the JAX package on the CPU.

Parameters are the JAX package's own (``init_lm_params`` and its parts,
from ``jax.random`` keys), carried across by ``repro_torch.convert``;
inputs are drawn with numpy from seeds.  The port runs on the CPU, where
attention takes the plain paths (``_sdpa``, ``_chunked_sdpa``) that stand
as the CUDA kernel's oracle on a card.

Tolerances.  Float32 parameters (as ``test_decode_matches_forward`` uses)
give tight parity, only the summation order differing: logits, attention
outputs and MoE outputs within ``F32_ATOL = 1e-4`` (measured here: at most
5e-6 on logits of magnitude 4), losses and aux within ``rtol=1e-5``.
Bfloat16 parameters round every product in both packages, in different
places: logits within ``BF16_SHARE = 5%`` of their largest magnitude
(measured: at most 2.0%, DeepSeek-V3's MLA).  Expert loads, the dropped
pairs, the sharding tables and greedy tokens are equal exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import repro.launch.serve as jax_serve
import repro.models.attention as JA
import repro.models.moe as JM
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import LMConfig as JaxLMConfig
from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.data.synthetic import make_batch as jax_make_batch
from repro.dist.sharding import gnn_param_specs as jax_gnn_specs
from repro.dist.sharding import lm_param_specs as jax_lm_specs
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_bundle as jax_build_bundle
from repro.models.gnn.pna import init_pna
from repro.models.transformer import init_lm_cache as jax_init_lm_cache
from repro.models.transformer import init_lm_params
from repro.models.transformer import lm_decode_step as jax_lm_decode_step
from repro.models.transformer import lm_forward as jax_lm_forward
from repro.models.transformer import lm_loss_and_stats as jax_lm_loss_and_stats
import repro_torch.models.attention as A
from repro_torch.configs import ARCHS
from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import _load_tree, gnn_params_from_numpy, lm_params_from_numpy
from repro_torch.dist.sharding import gnn_param_specs, lm_param_specs
from repro_torch.launch.serve import greedy_decode, serve_batch
from repro_torch.launch.steps import build_bundle
from repro_torch.models.moe import (
    MoE,
    _capacity,
    _n_groups,
    moe_ffn,
    route,
    update_router_bias,
)
from repro_torch.models.transformer import (
    Transformer,
    init_lm_cache,
    lm_decode_step,
    lm_forward,
    lm_loss_and_stats,
)

LM_ARCHS = [a for a, s in JAX_ARCHS.items() if s.family == "lm"]
F32_ATOL, LOSS_RTOL, BF16_SHARE = 1e-4, 1e-5, 0.05
KEY = jax.random.PRNGKey(0)


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(vocab: int, shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _models(arch: str, dtype=jnp.float32):
    jcfg = jax_reduced_config(JAX_ARCHS[arch])
    cfg = reduced_config(ARCHS[arch])
    params = init_lm_params(KEY, jcfg, dtype)
    return jcfg, cfg, params, lm_params_from_numpy(numpy_tree(params), cfg, device="cpu")


def _copy_into(module: torch.nn.Module, tree) -> torch.nn.Module:
    _load_tree(module, numpy_tree(tree))
    return module


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_matches_jax(arch):
    jcfg, cfg, params, model = _models(arch)
    toks = _tokens(cfg.vocab, (2, 16))
    j_logits, j_aux = jax_lm_forward(params, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        logits, aux = lm_forward(model, T(toks))
    assert logits.shape == (2, 16, cfg.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_bf16_matches_jax(arch):
    jcfg, cfg, params, model = _models(arch, jnp.bfloat16)
    assert model.embed.dtype == torch.bfloat16 and model.stacks()[-1][1][0].attn_norm.dtype \
        == torch.bfloat16
    toks = _tokens(cfg.vocab, (2, 16))
    j_logits = np.asarray(jax_lm_forward(params, jcfg, jnp.asarray(toks))[0].astype(jnp.float32))
    with torch.inference_mode():
        logits = lm_forward(model, T(toks))[0]
    assert logits.dtype == torch.bfloat16
    err = np.abs(logits.float().numpy() - j_logits).max()
    assert err <= BF16_SHARE * np.abs(j_logits).max(), err


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_moe_loads_match_jax(arch):
    jcfg, cfg, params, model = _models(arch)
    toks = _tokens(cfg.vocab, (2, 17), seed=1)
    j_loss, j_stats = jax_lm_loss_and_stats(params, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        loss, stats = lm_loss_and_stats(model, T(toks))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    if j_stats["moe_loads"] is None:
        assert stats["moe_loads"] is None
    else:
        # fractions of counts: equal routing gives equal bits
        np.testing.assert_array_equal(stats["moe_loads"].numpy(), np.asarray(j_stats["moe_loads"]))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_replay_matches_jax_step_by_step(arch):
    """Each decode step's logits and every cache leaf against the JAX
    package's, over 12 positions into a 16-slot cache (SWA archs: an
    8-slot ring, which wraps)."""
    jcfg, cfg, params, model = _models(arch)
    toks = _tokens(cfg.vocab, (1, 12), seed=2)
    j_cache = jax_init_lm_cache(jcfg, 1, 16, jnp.float32)
    cache = init_lm_cache(cfg, 1, 16, torch.float32, device="cpu")
    assert jax.tree.map(np.shape, j_cache) == {
        k: {n: tuple(t.shape) for n, t in v.items()} for k, v in cache.items()}
    for pos in range(12):
        j_lg, j_cache = jax_lm_decode_step(params, jcfg, j_cache, jnp.asarray(toks[:, pos:pos + 1]),
                                           jnp.int32(pos))
        with torch.inference_mode():
            lg, cache = lm_decode_step(model, cache, T(toks[:, pos:pos + 1]), pos)
        np.testing.assert_allclose(lg.numpy(), np.asarray(j_lg), atol=F32_ATOL, rtol=0)
        for key, leaves in cache.items():
            for name, t in leaves.items():
                np.testing.assert_allclose(t.numpy(), np.asarray(j_cache[key][name]),
                                           atol=F32_ATOL, rtol=0, err_msg=f"{pos} {key}.{name}")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_forward(arch):
    """The reference's own claim, on the port: greedy prefix replay through
    the decode path gives the full forward's logits (cache layout, RoPE
    positions, ring semantics); float32, within 0.05 as there."""
    _, cfg, _, model = _models(arch)
    toks = T(_tokens(cfg.vocab, (1, 12), seed=3))
    cache = init_lm_cache(cfg, 1, 16, torch.float32, device="cpu")
    with torch.inference_mode():
        full = lm_forward(model, toks)[0]
        errs = []
        for pos in range(12):
            lg, cache = lm_decode_step(model, cache, toks[:, pos:pos + 1], pos)
            errs.append(float((lg[0, 0] - full[0, pos]).abs().max()))
    assert max(errs) < 0.05, errs


def test_swa_ring_cache_is_window_sized():
    red = reduced_config(ARCHS["mixtral-8x22b"])
    cache = init_lm_cache(red, 1, 524288, device="cpu")
    j_cache = jax_init_lm_cache(jax_reduced_config(JAX_ARCHS["mixtral-8x22b"]), 1, 524288)
    assert cache["moe"]["k"].shape[2] == red.sliding_window
    assert tuple(cache["moe"]["k"].shape) == j_cache["moe"]["k"].shape
    assert cache["moe"]["k"].dtype == torch.bfloat16
    # a full-attention arch keeps the whole context
    tiny = reduced_config(ARCHS["tinyllama-1.1b"])
    assert init_lm_cache(tiny, 1, 100, device="cpu")["dense"]["k"].shape[2] == 100


# -- attention paths ---------------------------------------------------------------


@pytest.fixture
def _restore_thresholds():
    saved = [(m, m.CHUNKED_ATTN_THRESHOLD, m._ATTN_CHUNK) for m in (A, JA)]
    yield
    for m, thr, chunk in saved:
        m.CHUNKED_ATTN_THRESHOLD, m._ATTN_CHUNK = thr, chunk


def _set_thresholds(thr, chunk):
    for m in (A, JA):
        m.CHUNKED_ATTN_THRESHOLD, m._ATTN_CHUNK = thr, chunk


def _gqa_cfgs(window):
    kw = dict(name="t", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
              d_ff=128, vocab=64, sliding_window=window)
    return JaxLMConfig(**kw), LMConfig(**kw)


@pytest.mark.parametrize("window", [None, 16])
def test_gqa_forward_plain_paths_match_jax(window, _restore_thresholds):
    """Dense ``_sdpa`` and chunked ``_chunked_sdpa``, each against the JAX
    package's same path and against each other (``test_attention_paths``'s
    thresholds: chunks of 16 over S = 64)."""
    jcfg, cfg = _gqa_cfgs(window)
    p = JA.init_gqa_params(KEY, jcfg, jnp.float32)
    tp = _copy_into(A.GQAAttention(cfg, dtype=torch.float32), p)
    x = np.random.default_rng(4).standard_normal((2, 64, 64)).astype(np.float32)
    outs = {}
    for name, thr in (("dense", 10**9), ("chunked", 32)):
        _set_thresholds(thr, 16)
        j = np.asarray(JA.gqa_forward(p, jcfg, jnp.asarray(x)))
        with torch.inference_mode():
            outs[name] = A.gqa_forward(tp, cfg, T(x)).numpy()
        np.testing.assert_allclose(outs[name], j, atol=2e-5, rtol=0, err_msg=name)
    np.testing.assert_allclose(outs["dense"], outs["chunked"], atol=2e-5, rtol=0)


def _mla_cfgs(small=False):
    if small:
        kw = dict(name="t", n_layers=1, d_model=48, n_heads=2, n_kv_heads=2, d_head=16,
                  d_ff=96, vocab=32)
        mla = dict(q_lora_rank=24, kv_lora_rank=12, qk_nope_dim=12, qk_rope_dim=8, v_head_dim=12)
    else:
        kw = dict(name="t", n_layers=1, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
                  d_ff=128, vocab=64)
        mla = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    return JaxLMConfig(**kw, mla=JaxMLAConfig(**mla)), LMConfig(**kw, mla=MLAConfig(**mla))


def test_mla_dense_and_chunked_match_jax(_restore_thresholds):
    jcfg, cfg = _mla_cfgs()
    p = JA.init_mla_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = _copy_into(A.MLAAttention(cfg, dtype=torch.float32), p)
    x = np.random.default_rng(5).standard_normal((2, 64, 64)).astype(np.float32)
    outs = {}
    for name, thr in (("dense", 10**9), ("chunked", 32)):
        _set_thresholds(thr, 16)
        j = np.asarray(JA.mla_forward(p, jcfg, jnp.asarray(x)))
        with torch.inference_mode():
            outs[name] = A.mla_forward(tp, cfg, T(x)).numpy()
        np.testing.assert_allclose(outs[name], j, atol=2e-5, rtol=0, err_msg=name)
    np.testing.assert_allclose(outs["dense"], outs["chunked"], atol=2e-5, rtol=0)


def test_mla_absorbed_decode_matches_jax_and_forward():
    """The absorbed-weight decode reproduces the expanded forward position
    by position (fp32, the reference's 1e-4) and the JAX decode's outputs
    and latent cache; a position past the cache raises."""
    jcfg, cfg = _mla_cfgs(small=True)
    p = JA.init_mla_params(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = _copy_into(A.MLAAttention(cfg, dtype=torch.float32), p)
    x = np.random.default_rng(6).standard_normal((1, 10, 48)).astype(np.float32)
    j_cache = JA.init_mla_cache(jcfg, 1, 16, jnp.float32)
    cache = A.init_mla_cache(cfg, 1, 16, torch.float32, device="cpu")
    with torch.inference_mode():
        full = A.mla_forward(tp, cfg, T(x))
        for pos in range(10):
            o, cache = A.mla_decode(tp, cfg, T(x[:, pos:pos + 1]), cache, pos)
            jo, j_cache = JA.mla_decode(p, jcfg, jnp.asarray(x[:, pos:pos + 1]), j_cache,
                                        jnp.int32(pos))
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
            np.testing.assert_allclose(o[0, 0].numpy(), full[0, pos].numpy(), atol=1e-4,
                                       rtol=1e-4)
        for name in ("c", "k_rope"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(j_cache[name]),
                                       atol=2e-5, rtol=0)
        with pytest.raises(ValueError, match="outside a cache"):
            A.mla_decode(tp, cfg, T(x[:, :1]), cache, 16)


def test_gqa_ring_decode_matches_jax_past_the_window():
    """A window-8 ring cache driven to position 19: writes wrap modulo 8 and
    entries are masked by logical position, as in the reference."""
    jcfg, cfg = _gqa_cfgs(8)
    p = JA.init_gqa_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = _copy_into(A.GQAAttention(cfg, dtype=torch.float32), p)
    x = np.random.default_rng(7).standard_normal((2, 20, 64)).astype(np.float32)
    j_cache = JA.init_gqa_cache(jcfg, 2, 8, jnp.float32)
    cache = A.init_gqa_cache(cfg, 2, 8, torch.float32, device="cpu")
    with torch.inference_mode():
        full = A.gqa_forward(tp, cfg, T(x))
        for pos in range(20):
            o, cache = A.gqa_decode(tp, cfg, T(x[:, pos:pos + 1]), cache, pos)
            jo, j_cache = JA.gqa_decode(p, jcfg, jnp.asarray(x[:, pos:pos + 1]), j_cache,
                                        jnp.int32(pos))
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
            np.testing.assert_allclose(o[:, 0].numpy(), full[:, pos].numpy(), atol=1e-4)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(j_cache["k"]), atol=2e-5)


# -- MoE -------------------------------------------------------------------------------


def _jax_kept_pairs(params, cfg, x) -> np.ndarray:
    """``[T, K]`` bool: the reference's drop rule (``moe.py:80-120``), run in
    JAX on its own routing."""
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


MOE_CASES = [
    # (t, e, k, seed, capacity_factor): test_moe_dispatch.py's grid, ample
    # capacity, then drop-heavy factors
    (8, 2, 1, 0, 8.0), (24, 4, 2, 1, 8.0), (64, 8, 2, 2, 8.0), (96, 8, 1, 3, 8.0),
    (96, 4, 2, 4, 8.0), (64, 2, 2, 5, 8.0),
    (256, 4, 2, 6, 0.5), (512, 8, 2, 7, 0.25), (384, 8, 1, 8, 0.6),
]


@pytest.mark.parametrize("t,e,k,seed,cf", MOE_CASES)
def test_moe_ffn_matches_jax(t, e, k, seed, cf):
    """y and aux within tolerance; the expert loads and the set of dropped
    (token, k) pairs exactly."""
    cfg_kw = dict(n_experts=e, top_k=k, d_ff_expert=16, capacity_factor=cf)
    jcfg, cfg = JaxMoEConfig(**cfg_kw), MoEConfig(**cfg_kw)
    key = jax.random.PRNGKey(seed)
    params = JM.init_moe_params(key, 8, jcfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal((t, 8)).astype(np.float32)
    jy, jaux, jload = JM.moe_ffn(params, jcfg, jnp.asarray(x))
    p = _copy_into(MoE(8, cfg, dtype=torch.float32), params)
    with torch.inference_mode():
        y, aux, load = moe_ffn(p, cfg, T(x))
        kept = route(p, cfg, T(x)).kept().numpy()
    assert (_n_groups(t), _capacity(t // _n_groups(t), cfg)) == (
        JM._n_groups(t), JM._capacity(t // JM._n_groups(t), jcfg))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    np.testing.assert_array_equal(kept, _jax_kept_pairs(params, jcfg, jnp.asarray(x)))
    if cf < 1:
        assert not kept.all()  # the drop rule ran


def test_moe_top_k_ties_go_to_the_lower_expert():
    """Tied router logits (a zero router): jax.lax.top_k picks the lowest
    indices, and so must the port, or the dispatch would differ."""
    cfg_kw = dict(n_experts=4, top_k=2, d_ff_expert=16, capacity_factor=1.0)
    jcfg, cfg = JaxMoEConfig(**cfg_kw), MoEConfig(**cfg_kw)
    params = JM.init_moe_params(jax.random.PRNGKey(9), 8, jcfg, jnp.float32)
    params["router"] = jnp.zeros_like(params["router"])
    x = np.random.default_rng(9).standard_normal((32, 8)).astype(np.float32)
    p = _copy_into(MoE(8, cfg, dtype=torch.float32), params)
    with torch.inference_mode():
        r = route(p, cfg, T(x))
        y = moe_ffn(p, cfg, T(x))[0]
    assert (r.top_idx.reshape(-1, 2).numpy() == [0, 1]).all()
    np.testing.assert_array_equal(r.kept().numpy(), _jax_kept_pairs(params, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), np.asarray(JM.moe_ffn(params, jcfg, jnp.asarray(x))[0]),
                               atol=F32_ATOL)


def test_moe_aux_free_bias_and_shared_experts_match_jax():
    """DeepSeek-V3's options: a non-zero selection bias moves the routing,
    and the shared experts add to every token."""
    cfg_kw = dict(n_experts=8, top_k=2, d_ff_expert=16, n_shared=1, aux_free_bias=True,
                  capacity_factor=1.0)
    jcfg, cfg = JaxMoEConfig(**cfg_kw), MoEConfig(**cfg_kw)
    params = JM.init_moe_params(jax.random.PRNGKey(10), 8, jcfg, jnp.float32)
    params["router_bias"] = jnp.asarray(
        np.random.default_rng(10).standard_normal(8).astype(np.float32))
    x = np.random.default_rng(11).standard_normal((96, 8)).astype(np.float32)
    jy, jaux, jload = JM.moe_ffn(params, jcfg, jnp.asarray(x))
    p = _copy_into(MoE(8, cfg, dtype=torch.float32), params)
    assert not p.router_bias.requires_grad
    with torch.inference_mode():
        y, aux, load = moe_ffn(p, cfg, T(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_ATOL)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LOSS_RTOL)


def test_update_router_bias_matches_jax():
    load = np.random.default_rng(12).dirichlet(np.ones(8), size=3).astype(np.float32)
    bias = np.random.default_rng(13).standard_normal((3, 8)).astype(np.float32)
    j = np.asarray(JM.update_router_bias(jnp.asarray(bias), jnp.asarray(load)))
    np.testing.assert_array_equal(update_router_bias(T(bias), T(load)).numpy(), j)
    # overloaded experts go down, starved ones up
    new = update_router_bias(torch.zeros(1, 4), torch.tensor([[0.5, 0.3, 0.1, 0.1]]))
    assert float(new[0, 0]) < 0 and float(new[0, 2]) > 0


# -- sharding tables, conversion ------------------------------------------------------


def _jax_spec_by_name(tree, specs) -> dict:
    """The reference's spec tuple per port parameter name: a stacked layer
    leaf ``[L, ...]`` becomes L leaves without the leading None."""
    out = {}
    flat_specs = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, PartitionSpec))[0]
    for (path, leaf), (_, spec) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                       flat_specs):
        keys = [str(getattr(p, "key", getattr(p, "idx", None))) for p in path]
        spec = tuple(spec)
        if keys[0] in ("dense_layers", "moe_layers"):
            assert spec[0] is None
            for i in range(leaf.shape[0]):
                out[".".join([keys[0], str(i), *keys[1:]])] = spec[1:]
        else:
            out[".".join(keys)] = spec
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_sharding_table_equals_the_reference(arch):
    jcfg = jax_reduced_config(JAX_ARCHS[arch])
    abstract = jax.eval_shape(lambda k: init_lm_params(k, jcfg), KEY)
    want = _jax_spec_by_name(abstract, jax_lm_specs(abstract))
    model = Transformer(reduced_config(ARCHS[arch]), device="cpu")
    got = lm_param_specs(model)
    assert got == want
    assert set(got) == {n for n, _ in model.named_parameters()}


def test_sharding_tables_raise_on_an_unknown_leaf_and_cover_gnn():
    model = Transformer(reduced_config(ARCHS["tinyllama-1.1b"]), device="cpu")
    model.extra_leaf = torch.nn.Parameter(torch.zeros(4, 4))
    with pytest.raises(KeyError, match="extra_leaf"):
        lm_param_specs(model)
    jcfg = jax_reduced_config(JAX_ARCHS["pna"])
    tree = numpy_tree(init_pna(KEY, jcfg, 12, 5))
    pna = gnn_params_from_numpy("pna", tree, reduced_config(ARCHS["pna"]), device="cpu")
    want = {n: () for n in _jax_spec_by_name(tree, jax_gnn_specs(tree))}
    assert gnn_param_specs(pna) == want


def test_lm_params_from_numpy_checks_every_leaf():
    jcfg = jax_reduced_config(JAX_ARCHS["mixtral-8x22b"])
    cfg = reduced_config(ARCHS["mixtral-8x22b"])
    tree = numpy_tree(init_lm_params(KEY, jcfg, jnp.float32))
    missing = dict(tree)
    del missing["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        lm_params_from_numpy(missing, cfg, device="cpu")
    extra = dict(tree, bogus=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="bogus"):
        lm_params_from_numpy(extra, cfg, device="cpu")
    wrong = dict(tree, embed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_numpy(wrong, cfg, device="cpu")
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    assert len(model.moe_layers) == jcfg.n_moe_layers
    np.testing.assert_array_equal(model.moe_layers[1].moe.we_up.detach().numpy(),
                                  tree["moe_layers"]["moe"]["we_up"][1])


def test_lm_models_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot show here")
    cfg = reduced_config(ARCHS["tinyllama-1.1b"])
    for build in (lambda: Transformer(cfg), lambda: init_lm_cache(cfg, 1, 8),
                  lambda: build_bundle("tinyllama-1.1b", "prefill_32k", reduced=True),
                  lambda: serve_batch("tinyllama-1.1b", verbose=False)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


# -- steps and serving -----------------------------------------------------------------


@pytest.fixture(scope="module")
def host_mesh():
    return make_host_mesh()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x22b", "deepseek-v3-671b"])
def test_lm_serving_steps_match_jax(arch, host_mesh):
    """The prefill step's next token (last position only) and three decode
    steps' tokens, against the JAX bundles' step functions run on the same
    float32 parameters and inputs."""
    jcfg, cfg, params, model = _models(arch)
    jb = jax_build_bundle(arch, "prefill_32k", host_mesh, reduced=True)
    tb = build_bundle(arch, "prefill_32k", reduced=True, device="cpu")
    assert tb.abstract_inputs["tokens"].shape == jb.abstract_inputs["tokens"].shape
    assert tb.input_bounds == jb.input_bounds
    batch = jax_make_batch(jb.abstract_inputs, seed=0, step=0, bounds=jb.input_bounds)
    j_next = np.asarray(jb.step_fn({"params": params}, batch)["next_token"])
    out = tb.step_fn({"params": model}, {"tokens": T(batch["tokens"])})
    np.testing.assert_array_equal(out["next_token"].numpy(), j_next)

    jd = jax_build_bundle(arch, "decode_32k", host_mesh, reduced=True)
    td = build_bundle(arch, "decode_32k", reduced=True, device="cpu")
    j_state = {"params": params, "cache": jax_init_lm_cache(jcfg, 2, 64, jnp.float32)}
    state = {"params": model, "cache": init_lm_cache(cfg, 2, 64, torch.float32, "cpu")}
    assert {k: v.shape for k, v in td.abstract_inputs.items()} == {
        k: v.shape for k, v in jd.abstract_inputs.items()}
    tok = _tokens(cfg.vocab, (2, 1), seed=4)
    for pos in range(3):
        j_state, j_out = jd.step_fn(j_state, {"tokens": jnp.asarray(tok), "pos": jnp.int32(pos)})
        state, out = td.step_fn(state, {"tokens": T(tok), "pos": pos})
        np.testing.assert_array_equal(out["next_token"].numpy(), np.asarray(j_out["next_token"]))
        tok = np.asarray(j_out["next_token"])[:, None]


def test_train_kinds_and_gnn_bundles_are_not_ported_yet():
    for arch, shape in (("tinyllama-1.1b", "train_4k"), ("deepfm", "train_batch"),
                        ("pna", "full_graph_sm")):
        with pytest.raises(NotImplementedError):
            build_bundle(arch, shape, reduced=True, device="cpu")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_batch_tokens_equal_jax(arch, monkeypatch):
    """The JAX package's ``serve_batch`` on float32 parameters and cache (its
    init functions wrapped), and the port's ``greedy_decode`` on the same
    parameters and prompts: the same greedy tokens."""
    captured = {}
    init, init_cache = jax_serve.init_lm_params, jax_serve.init_lm_cache

    def init32(key, cfg):
        captured["params"] = init(key, cfg, jnp.float32)
        return captured["params"]

    monkeypatch.setattr(jax_serve, "init_lm_params", init32)
    monkeypatch.setattr(jax_serve, "init_lm_cache",
                        lambda cfg, b, n: init_cache(cfg, b, n, jnp.float32))
    j_tokens = jax_serve.serve_batch(arch, batch=2, prompt_len=8, gen_tokens=8, verbose=False)
    jcfg = jax_reduced_config(JAX_ARCHS[arch])
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 8), 0, jcfg.vocab))
    model = lm_params_from_numpy(numpy_tree(captured["params"]), reduced_config(ARCHS[arch]),
                                 device="cpu")
    res = greedy_decode(model, T(prompts), 8)
    np.testing.assert_array_equal(res["tokens"], np.asarray(j_tokens))


def test_serve_batch_runs_its_reduced_config_on_the_cpu(capsys):
    tokens = serve_batch("mixtral-8x22b", batch=2, prompt_len=4, gen_tokens=3, device="cpu")
    assert tokens.shape == (2, 3) and tokens.dtype == np.int64
    assert (tokens >= 0).all() and (tokens < reduced_config(ARCHS["mixtral-8x22b"]).vocab).all()
    assert "[serve] mixtral-8x22b" in capsys.readouterr().out
    again = serve_batch("mixtral-8x22b", batch=2, prompt_len=4, gen_tokens=3, device="cpu",
                        verbose=False)
    np.testing.assert_array_equal(tokens, again)


def test_reduced_lm_configs_equal_the_reference():
    for arch in LM_ARCHS:
        assert dataclasses.asdict(reduced_config(ARCHS[arch])) == dataclasses.asdict(
            jax_reduced_config(JAX_ARCHS[arch]))
