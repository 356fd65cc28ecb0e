"""Attention variants: GQA (with an optional sliding window) and DeepSeek MLA
(``repro.models.attention`` counterpart).

Parameters are ``nn.Module``s holding the reference's leaves by name
(``wq``, ``wk``, ``wv``, ``wo``; MLA's ``w_dq`` ... ``wo``), in its
``[d_in, d_out]`` layout.  Two call modes, as in the reference:

  * full sequence (train / prefill): causal masking, positions 0..S-1.
    GQA prefill on a card (``backend`` None or ``"cuda"`` on CUDA tensors,
    no gradient asked for) runs the hand-written CUDA flash kernel
    (``kernels.flash_attention``): causal, the config's window, GQA, scale
    ``1/sqrt(d_head)``, where the kernel takes the head dim
    (``d_head <= 128``).  The kernel has no backward: where a gradient is
    asked for, ``backend=None`` takes the plain paths, as the reference
    trains, and ``"cuda"`` raises.  The ``torch`` backend, and the CPU,
    run the reference's plain paths, kept as the kernel's oracle:
    ``_sdpa`` (the scores rounded to the inputs' dtype before the float32
    softmax, the probabilities cast back, as the reference does) and, at
    ``s >= CHUNKED_ATTN_THRESHOLD`` with ``s % _ATTN_CHUNK == 0``, the
    streaming-softmax ``_chunked_sdpa``.  Both thresholds are module
    attributes, read at call time.  Under grad every chunk body of
    ``_chunked_sdpa`` and of MLA's ``_mla_chunked`` is checkpointed, as
    the reference's ``jax.checkpoint`` does: the backward recomputes a
    chunk's scores instead of keeping every chunk's float32 scores.
  * decode: one new token against a fixed-size cache, written in place at
    ``pos`` (GQA: at ``pos mod T``, a ring buffer under a sliding window).

MLA stays plain PyTorch on every device: its qk dim (nope + rope) is not
its v dim, which is not the kernel's function, and the reference computes
it outside any Pallas kernel; so does decode attention (one query row
against a cache).  MLA caches only the compressed latent ``(c, k_rope)``
and decodes with the absorbed weights, scoring against the latent directly.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.build import validate_backend
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import apply_rope, init_dense, model_device, rms_norm, rope_angles

_NEG = -1e30

# Sequences at or above this length take the chunked (streaming-softmax)
# plain path, which never holds an S x S score tensor (the reference's
# values).
CHUNKED_ATTN_THRESHOLD = 4096
_ATTN_CHUNK = 1024


def _scale(d: int) -> float:
    """``1 / sqrt(d)`` rounded as the reference's float32 arithmetic."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _use_chunked(s: int) -> bool:
    return s >= CHUNKED_ATTN_THRESHOLD and s % _ATTN_CHUNK == 0


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _chunk_step(body, *args):
    """``body(*args)``, checkpointed where a gradient is asked for (the
    backward then recomputes it from its inputs)."""
    if _wants_grad(*args):
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


class GQAAttention(nn.Module):
    """The reference's ``init_gqa_params`` leaves: ``wq [d, H*dh]``,
    ``wk``/``wv [d, Hk*dh]``, ``wo [H*dh, d]``."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator | None = None,
                 dtype=torch.bfloat16):
        super().__init__()
        d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = nn.Parameter(init_dense(generator, d, h * dh, dtype))
        self.wk = nn.Parameter(init_dense(generator, d, hk * dh, dtype))
        self.wv = nn.Parameter(init_dense(generator, d, hk * dh, dtype))
        self.wo = nn.Parameter(init_dense(generator, h * dh, d, dtype))


def _sdpa(q, k, v, mask, scale: float):
    """q [B,S,H,dh], k/v [B,T,Hk,dh] with H = G*Hk; mask broadcastable to
    [.., S, T]."""
    b, s, h, dh = q.shape
    hk = k.shape[2]
    g = h // hk
    q = q.reshape(b, s, hk, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32) * scale
    scores = scores + torch.where(mask, 0.0, _NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


def causal_mask(s: int, window: int | None = None, device=None) -> torch.Tensor:
    q_pos = torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    m = k_pos <= q_pos
    if window is not None:
        m &= k_pos > q_pos - window
    return m


def _chunked_sdpa(q, k, v, scale: float, window: int | None):
    """Causal attention by a streaming softmax over KV chunks: q [B,S,H,dh],
    k/v [B,S,Hk,dh] -> [B,S,H,dh], running (max, sum, acc) in float32."""
    b, s, h, dh = q.shape
    hk = k.shape[2]
    g = h // hk
    c = min(_ATTN_CHUNK, s)
    qr = q.reshape(b, s, hk, g, dh)
    q_pos = torch.arange(s, device=q.device)

    def body(m, l, acc, qr, kj, vj, k_pos):
        scores = torch.einsum("bskgd,btkd->bkgst", qr, kj).to(torch.float32) * scale
        mask = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        scores = torch.where(mask, scores, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        # a fully masked chunk has m_new == _NEG, where exp(scores - m_new)
        # would be 1, not 0: mask p explicitly
        p = torch.exp(scores - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p, vj.to(torch.float32))
        return m_new, l, acc

    m = torch.full((b, hk, g, s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hk, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, g, s, dh), dtype=torch.float32, device=q.device)
    for j in range(s // c):
        kj, vj = k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c]
        k_pos = j * c + torch.arange(c, device=q.device)
        m, l, acc = _chunk_step(body, m, l, acc, qr, kj, vj, k_pos)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def gqa_qkv(p: GQAAttention, cfg: LMConfig, x: torch.Tensor, positions=None):
    """The projections of x [B,S,D] after RoPE: q [B,S,H,dh], k and v
    [B,S,Hk,dh], each a fresh contiguous tensor."""
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = (x @ p.wq).reshape(b, s, h, dh)
    k = (x @ p.wk).reshape(b, s, hk, dh)
    v = (x @ p.wv).reshape(b, s, hk, dh)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_attend(q, k, v, cfg: LMConfig, *, backend: str | None = None) -> torch.Tensor:
    """Causal (and windowed) GQA over rope'd q, k, v: the CUDA flash kernel
    on a card (which raises for a head dim it cannot take, and under grad),
    else the plain paths; ``backend=None`` takes the plain paths where a
    gradient is asked for."""
    if backend is None and _wants_grad(q, k, v):
        backend = "torch"
    backend = validate_backend(backend, q.device)
    s, dh = q.shape[1], q.shape[3]
    if backend == "cuda":
        return flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                               backend="cuda")
    if _use_chunked(s):
        return _chunked_sdpa(q, k, v, _scale(dh), cfg.sliding_window)
    return _sdpa(q, k, v, causal_mask(s, cfg.sliding_window, q.device), _scale(dh))


def gqa_forward(p: GQAAttention, cfg: LMConfig, x: torch.Tensor, *, positions=None,
                backend: str | None = None) -> torch.Tensor:
    """Full-sequence causal attention. x [B,S,D] -> [B,S,D]."""
    b, s, _ = x.shape
    q, k, v = gqa_qkv(p, cfg, x, positions)
    out = gqa_attend(q, k, v, cfg, backend=backend)
    return out.reshape(b, s, -1) @ p.wo


def cache_shapes(cfg: LMConfig, batch: int, cache_len: int) -> dict:
    """One layer's decode cache, name -> shape: GQA's ``k``/``v``
    ``[B, T, Hk, dh]``, MLA's latent ``c [B, T, R]`` and ``k_rope``."""
    if cfg.mla:
        m = cfg.mla
        return {"c": (batch, cache_len, m.kv_lora_rank),
                "k_rope": (batch, cache_len, m.qk_rope_dim)}
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": shape, "v": shape}


def _zeros_cache(shapes: dict, dtype, device) -> dict:
    device = model_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in shapes.items()}


def init_gqa_cache(cfg: LMConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device="cuda") -> dict:
    return _zeros_cache(cache_shapes(cfg, batch, cache_len), dtype, device)


def gqa_decode(p: GQAAttention, cfg: LMConfig, x: torch.Tensor, cache: dict, pos):
    """x [B,1,D], cache {k, v [B,T,Hk,dh]}, pos an int -> (out, cache), the
    cache written in place.

    Under a sliding window the cache is a ring buffer of the window's size:
    writes and reads wrap modulo its length, and entries are masked by
    their logical position."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    pos = int(pos)
    t = cache["k"].shape[1]
    q, k, v = gqa_qkv(p, cfg, x, torch.full((b, 1), pos, device=x.device))
    slot = pos % t  # ring write (no-op mod for full-length caches)
    start = min(slot, t - s)  # dynamic_update_slice's clamp
    cache["k"][:, start:start + s] = k
    cache["v"][:, start:start + s] = v
    # valid cache entries: logical positions (pos - t, pos]
    idx = torch.arange(t, device=x.device)
    logical = torch.where(idx <= slot, pos - slot + idx, pos - slot - t + idx)
    valid = (logical >= 0) & (logical <= pos)
    if cfg.sliding_window is not None:
        valid &= logical > pos - cfg.sliding_window
    out = _sdpa(q, cache["k"], cache["v"], valid[None, None, :], _scale(dh))
    return out.reshape(b, s, h * dh) @ p.wo, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek V2/V3)
# ---------------------------------------------------------------------------


class MLAAttention(nn.Module):
    """The reference's ``init_mla_params`` leaves."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator | None = None,
                 dtype=torch.bfloat16):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        qk = m.qk_nope_dim + m.qk_rope_dim
        dev = generator.device if generator is not None else None
        self.w_dq = nn.Parameter(init_dense(generator, d, m.q_lora_rank, dtype))
        self.q_norm = nn.Parameter(torch.ones(m.q_lora_rank, dtype=dtype, device=dev))
        self.w_uq = nn.Parameter(init_dense(generator, m.q_lora_rank, h * qk, dtype))
        self.w_dkv = nn.Parameter(init_dense(generator, d, m.kv_lora_rank, dtype))
        self.kv_norm = nn.Parameter(torch.ones(m.kv_lora_rank, dtype=dtype, device=dev))
        self.w_uk = nn.Parameter(init_dense(generator, m.kv_lora_rank, h * m.qk_nope_dim, dtype))
        self.w_uv = nn.Parameter(init_dense(generator, m.kv_lora_rank, h * m.v_head_dim, dtype))
        self.w_kr = nn.Parameter(init_dense(generator, d, m.qk_rope_dim, dtype))
        self.wo = nn.Parameter(init_dense(generator, h * m.v_head_dim, d, dtype))


def _mla_q(p: MLAAttention, cfg: LMConfig, x, positions):
    m = cfg.mla
    b, s, _ = x.shape
    qk = m.qk_nope_dim + m.qk_rope_dim
    q_lat = rms_norm(x @ p.w_dq, p.q_norm)
    q = (q_lat @ p.w_uq).reshape(b, s, cfg.n_heads, qk)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    cos, sin = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos[:, :, None, :], sin[:, :, None, :])
    return q_nope, q_rope


def _mla_latent(p: MLAAttention, cfg: LMConfig, x, positions):
    """The cached latent ``c`` [B,S,R] and the shared rope key [B,S,rope]."""
    c = rms_norm(x @ p.w_dkv, p.kv_norm)
    cos, sin = rope_angles(positions, cfg.mla.qk_rope_dim, cfg.rope_theta)
    k_rope = apply_rope((x @ p.w_kr)[:, :, None, :], cos[:, :, None, :],
                        sin[:, :, None, :])[:, :, 0]
    return c, k_rope


def mla_forward(p: MLAAttention, cfg: LMConfig, x: torch.Tensor, *, positions=None):
    """Full-sequence MLA. x [B,S,D] -> [B,S,D]."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c, k_rope = _mla_latent(p, cfg, x, positions)
    scale = _scale(m.qk_nope_dim + m.qk_rope_dim)
    if _use_chunked(s):
        out = _mla_chunked(p, cfg, q_nope, q_rope, c, k_rope, scale)
    else:
        k_nope = (c @ p.w_uk).reshape(b, s, h, m.qk_nope_dim)
        v = (c @ p.w_uv).reshape(b, s, h, m.v_head_dim)
        scores = (
            torch.einsum("bshe,bthe->bhst", q_nope, k_nope)
            + torch.einsum("bshe,bte->bhst", q_rope, k_rope)
        ).to(torch.float32) * scale
        scores = scores + torch.where(causal_mask(s, device=x.device), 0.0, _NEG)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhst,bthe->bshe", probs, v)
    return out.reshape(b, s, h * m.v_head_dim) @ p.wo


def _mla_chunked(p: MLAAttention, cfg: LMConfig, q_nope, q_rope, c, k_rope, scale: float):
    """Streaming-softmax MLA prefill: the per-head K/V are expanded from the
    latent one chunk at a time, so neither S x S scores nor the whole
    expanded K are ever held."""
    m = cfg.mla
    b, s, h, _ = q_nope.shape
    ch = min(_ATTN_CHUNK, s)
    w_uk = p.w_uk.reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    w_uv = p.w_uv.reshape(m.kv_lora_rank, h, m.v_head_dim)
    q_pos = torch.arange(s, device=c.device)

    def body(mx, l, acc, q_nope, q_rope, c_j, kr_j, k_pos, w_uk, w_uv):
        k_nope_j = torch.einsum("btr,rhe->bthe", c_j, w_uk)
        v_j = torch.einsum("btr,rhe->bthe", c_j, w_uv)
        scores = (
            torch.einsum("bshe,bthe->bhst", q_nope, k_nope_j)
            + torch.einsum("bshe,bte->bhst", q_rope, kr_j)
        ).to(torch.float32) * scale
        mask = k_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask, scores, _NEG)
        m_new = torch.maximum(mx, scores.amax(dim=-1))
        pr = torch.exp(scores - m_new[..., None]) * mask
        corr = torch.exp(mx - m_new)
        l = l * corr + pr.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bthe->bhse", pr, v_j.to(torch.float32))
        return m_new, l, acc

    mx = torch.full((b, h, s), _NEG, dtype=torch.float32, device=c.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=c.device)
    acc = torch.zeros((b, h, s, m.v_head_dim), dtype=torch.float32, device=c.device)
    for j in range(s // ch):
        c_j, kr_j = c[:, j * ch:(j + 1) * ch], k_rope[:, j * ch:(j + 1) * ch]
        k_pos = j * ch + torch.arange(ch, device=c.device)
        mx, l, acc = _chunk_step(body, mx, l, acc, q_nope, q_rope, c_j, kr_j, k_pos,
                                 w_uk, w_uv)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q_nope.dtype)


def init_mla_cache(cfg: LMConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device="cuda") -> dict:
    return _zeros_cache(cache_shapes(cfg, batch, cache_len), dtype, device)


def mla_decode(p: MLAAttention, cfg: LMConfig, x: torch.Tensor, cache: dict, pos):
    """Absorbed-weight decode: score against the cached latent directly.
    The latent is written in place at ``pos``, which must lie inside the
    cache (the reference's ``dynamic_update_slice`` would clamp it)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    pos = int(pos)
    t = cache["c"].shape[1]
    if not 0 <= pos <= t - s:
        raise ValueError(f"mla_decode: position {pos} outside a cache of {t}")
    positions = torch.full((b, 1), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_new, k_rope_new = _mla_latent(p, cfg, x, positions)
    cache["c"][:, pos:pos + s] = c_new
    cache["k_rope"][:, pos:pos + s] = k_rope_new
    c, k_rope = cache["c"], cache["k_rope"]

    # absorb W_uk into the query: q_abs [B,1,H,R]
    w_uk = p.w_uk.reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope, w_uk)
    scale = _scale(m.qk_nope_dim + m.qk_rope_dim)
    scores = (
        torch.einsum("bshr,btr->bhst", q_abs, c)
        + torch.einsum("bshe,bte->bhst", q_rope, k_rope)
    ).to(torch.float32) * scale
    mask = (torch.arange(t, device=x.device) <= pos)[None, None, None, :]
    scores = scores + torch.where(mask, 0.0, _NEG)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    # attend over the latent, then absorb W_uv on the way out
    o_lat = torch.einsum("bhst,btr->bshr", probs, c)
    w_uv = p.w_uv.reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bshr,rhe->bshe", o_lat, w_uv).reshape(b, s, h * m.v_head_dim)
    return out @ p.wo, cache

