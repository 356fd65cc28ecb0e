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
    streaming-softmax ``_chunked_sdpa``; MLA's ``_mla_chunked`` also tiles
    the queries (``_MLA_Q_TILE`` rows).  These sizes are module
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

On a mesh whose ``model`` axis splits the projections (``mesh=``, the
module placed by ``dist.sharding.place``), the full-sequence paths run on
the rank's heads, as the reference's rule tables place them: GQA's
``wq``/``wk``/``wv`` are column-parallel (H/T query and Hk/T KV heads a
rank, which keeps each query head with its KV head) and ``wo`` row-parallel,
its partial sums summed over the model axis (``reduce_from_model``); on a
card each rank runs the flash kernel on its own heads.  MLA splits
``w_uq``/``w_uk``/``w_uv``/``wo`` by head; its latent projections
``w_dq``/``w_dkv`` feed a norm over the whole latent, so where the model
axis splits their output dimension the rank gathers those latents over it
before the norm (``gather_from_model``).  FSDP shards are gathered over the
data axis where a layer reads them (``dist.sharding.weights``).  A layer
whose heads the model axis cannot split evenly, or whose spec
``fit_specs`` left whole, computes with its weights gathered whole.

Decode on a mesh (``time_split``: the cache's time axis split over
``model``, the reference's split-KV ``cache_spec``; each rank holds the
``T/t`` slots ``[r*T/t, (r+1)*T/t)`` of every head).  The rank computes its
heads' projections of the new token (column-parallel, as the prefill) and
gathers them over the model axis; the rank that owns the written slot
(``pos mod T``, the ring's clamp kept) writes it, the others write nothing;
each rank attends every head over its own slots, masked by the reference's
logical-position rule on global slot indices, and returns a float32
partial ``(max, sum of exponentials, unnormalised output)`` (a rank with
no valid slot yet returns zero weight: its probabilities are masked, not
only its scores).  The partials are all-gathered over ``model`` and merged
by the log-sum-exp rule in rank order, the same bits on every rank; the
rank's heads then go through the row-parallel ``wo``, summed over the
axis.  MLA does the same on its latents (``q_abs`` and ``q_rope``
gathered, ``c`` and ``k_rope`` split in time, the merge before ``w_uv``).
Where the time axis is whole (``REPRO_NO_SPLITKV``, or ``fit_specs``
dropped it), every rank holds the whole cache, writes every head's new
entry, and attends its own heads over it.  Decode attention stays plain
PyTorch, as the reference's, split or not.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.dist.sharding import (
    copy_to_model,
    gathered_matmul,
    model_split,
    reduce_from_model,
    weights,
)
from repro_torch.kernels.build import validate_backend
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import apply_rope, init_dense, model_device, rms_norm, rope_angles

_NEG = -1e30

# Sequences at or above this length take the chunked (streaming-softmax)
# plain path, which never holds an S x S score tensor (the reference's
# values).
CHUNKED_ATTN_THRESHOLD = 4096
_ATTN_CHUNK = 1024
# MLA's chunked prefill takes the queries this many rows at a time (read
# at call time)
_MLA_Q_TILE = 4096


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
    [B,S,Hk,dh], each a fresh contiguous tensor (H and Hk those of ``p``'s
    weights: a model rank's heads)."""
    b, s, _ = x.shape
    dh = cfg.d_head
    h, hk = p.wq.shape[1] // dh, p.wk.shape[1] // dh
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


_GQA = ("wq", "wk", "wv", "wo")


def _heads_axis(p, names, heads: tuple, mesh):
    """The model axis where it splits ``p``'s head projections ``names``
    and every head count of ``heads``; else None (the replicated path)."""
    if not model_split(p, names, mesh):
        return None
    t = mesh.model.world_size
    return mesh.model if all(n % t == 0 for n in heads) else None


def gqa_forward(p: GQAAttention, cfg: LMConfig, x: torch.Tensor, *, positions=None,
                backend: str | None = None, mesh=None) -> torch.Tensor:
    """Full-sequence causal attention. x [B,S,D] -> [B,S,D]; on ``mesh``'s
    model axis the rank's heads (see the module docstring)."""
    b, s, _ = x.shape
    axis = _heads_axis(p, _GQA, (cfg.n_heads, cfg.n_kv_heads), mesh)
    w = weights(p, mesh, _GQA, local=axis is not None)
    q, k, v = gqa_qkv(w, cfg, copy_to_model(x, axis), positions)
    out = gqa_attend(q, k, v, cfg, backend=backend)
    return reduce_from_model(out.reshape(b, s, -1) @ w.wo, axis)


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


def _ring_valid(cfg: LMConfig, pos: int, slot: int, t: int, idx: torch.Tensor) -> torch.Tensor:
    """The reference's valid cache entries: global slot indices ``idx`` of a
    ``t``-slot cache whose newest entry, at logical position ``pos``, lies
    in ``slot``: logical positions ``(pos - t, pos]`` (and inside the
    window)."""
    logical = torch.where(idx <= slot, pos - slot + idx, pos - slot - t + idx)
    valid = (logical >= 0) & (logical <= pos)
    if cfg.sliding_window is not None:
        valid &= logical > pos - cfg.sliding_window
    return valid


def _time_axis(mesh, time_split: bool):
    """The model axis where the cache's time axis is split over it."""
    if not time_split or mesh is None or mesh.model.world_size == 1:
        return None
    return mesh.model


def _gather_heads(axis, parts: list) -> list:
    """Each of ``parts`` (``[B, s, n/T, ...]``, the rank's heads) with every
    rank's heads, laid end to end in rank order: one all-gather."""
    every = axis.all_gather(torch.cat(parts, dim=2))  # [T, B, s, sum n/T, ...]
    chunks = every.split([t.shape[2] for t in parts], dim=3)
    return [torch.cat(list(c.unbind(0)), dim=2) for c in chunks]


def _owned_write(cache: dict, new: dict, start: int, axis, t_loc: int) -> None:
    """Write ``new`` (name -> ``[B, s, ...]``) at global slot ``start`` of a
    cache split in time over ``axis`` (``t_loc`` slots a rank): only the
    rank that owns the slot writes; no collective."""
    owner = start // t_loc
    if owner == axis.rank:
        at = start - owner * t_loc
        for name, v in new.items():
            cache[name][:, at:at + v.shape[1]] = v


def _partial(scores: torch.Tensor, mask: torch.Tensor):
    """Float32 scores ``[..., T]`` and their mask -> ``(max, unnormalised
    probabilities, their sum)``; a masked entry gets probability 0, so a
    rank with no valid slot adds no weight."""
    scores = torch.where(mask, scores, _NEG)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None]) * mask
    return m, p, p.sum(dim=-1)


def _merge_partials(axis, m: torch.Tensor, l: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Every model rank's partial ``(m [...], l [...], o [..., e])`` merged
    by the log-sum-exp rule: one all-gather, then the ranks' terms added in
    rank order (the same bits on every rank) -> ``o / l`` in float32."""
    every = axis.all_gather(torch.cat([m[..., None], l[..., None], o], dim=-1))
    ms, ls, os_ = every[..., 0], every[..., 1], every[..., 2:]
    w = torch.exp(ms - ms.amax(dim=0))  # a rank with no valid slot: exp(-1e30) = 0
    num, den = os_[0] * w[0][..., None], ls[0] * w[0]
    for j in range(1, every.shape[0]):
        num = num + os_[j] * w[j][..., None]
        den = den + ls[j] * w[j]
    return num / den[..., None]


def _rank_heads(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The model rank's block of heads of ``t`` along ``dim`` (all of them
    off a split)."""
    return t if axis is None else t.tensor_split(axis.world_size, dim=dim)[axis.rank]


def gqa_decode(p: GQAAttention, cfg: LMConfig, x: torch.Tensor, cache: dict, pos, *,
               mesh=None, time_split: bool = False):
    """x [B,1,D], cache {k, v [B,T,Hk,dh]}, pos an int -> (out, cache), the
    cache written in place.

    Under a sliding window the cache is a ring buffer of the window's size:
    writes and reads wrap modulo its length, and entries are masked by
    their logical position.  On ``mesh`` (see the module docstring) the
    rank's heads, and with ``time_split`` the rank's slots of a cache split
    in time over the model axis."""
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pos = int(pos)
    axis = _heads_axis(p, _GQA, (h, hk), mesh)
    w = weights(p, mesh, _GQA, local=axis is not None)
    tm = _time_axis(mesh, time_split)
    t_loc = cache["k"].shape[1]
    t = t_loc * (1 if tm is None else tm.world_size)
    q, k, v = gqa_qkv(w, cfg, x, torch.full((b, 1), pos, device=x.device))
    if axis is not None:  # every head's new k and v (and q, to attend every head)
        if tm is None:
            k, v = _gather_heads(axis, [k, v])
        else:
            q, k, v = _gather_heads(axis, [q, k, v])
    slot = pos % t  # ring write (no-op mod for full-length caches)
    start = min(slot, t - s)  # dynamic_update_slice's clamp
    if tm is None:
        cache["k"][:, start:start + s] = k
        cache["v"][:, start:start + s] = v
        valid = _ring_valid(cfg, pos, slot, t, torch.arange(t, device=x.device))
        out = _sdpa(q, _rank_heads(cache["k"], axis, 2), _rank_heads(cache["v"], axis, 2),
                    valid[None, None, :], _scale(dh))
    else:
        _owned_write(cache, {"k": k, "v": v}, start, tm, t_loc)
        valid = _ring_valid(cfg, pos, slot, t,
                            tm.rank * t_loc + torch.arange(t_loc, device=x.device))
        qr = q.reshape(b, s, hk, h // hk, dh)
        scores = torch.einsum("bskgd,btkd->bkgst", qr, cache["k"]).to(torch.float32) * _scale(dh)
        m, pr, l = _partial(scores, valid)
        o = torch.einsum("bkgst,btkd->bkgsd", pr.to(cache["v"].dtype), cache["v"]).float()
        out = _merge_partials(tm, m, l, o)  # [B, Hk, G, s, dh]
        out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(x.dtype)
        out = _rank_heads(out, axis, 2)
    return reduce_from_model(out.reshape(b, s, -1) @ w.wo, axis), cache


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


def _mla_q(p: MLAAttention, cfg: LMConfig, x, positions, heads=None, lat=None):
    """(q_nope, q_rope) of ``p``'s heads; ``heads``/``lat``: the model axis
    where it splits the heads / ``w_dq``'s latent (gathered before its
    norm)."""
    m = cfg.mla
    b, s, _ = x.shape
    qk = m.qk_nope_dim + m.qk_rope_dim
    q_lat = copy_to_model(rms_norm(gathered_matmul(x, p.w_dq, lat), p.q_norm), heads)
    q = (q_lat @ p.w_uq).reshape(b, s, p.w_uq.shape[1] // qk, qk)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    cos, sin = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos[:, :, None, :], sin[:, :, None, :])
    return q_nope, q_rope


def _mla_latent(p: MLAAttention, cfg: LMConfig, x, positions, heads=None, lat=None):
    """The cached latent ``c`` [B,S,R] and the shared rope key [B,S,rope]
    (``heads``/``lat`` as in ``_mla_q``, for ``w_dkv``)."""
    c = rms_norm(gathered_matmul(x, p.w_dkv, lat), p.kv_norm)
    cos, sin = rope_angles(positions, cfg.mla.qk_rope_dim, cfg.rope_theta)
    k_rope = apply_rope((x @ p.w_kr)[:, :, None, :], cos[:, :, None, :],
                        sin[:, :, None, :])[:, :, 0]
    return copy_to_model(c, heads), copy_to_model(k_rope, heads)


_MLA_HEADS = ("w_uq", "w_uk", "w_uv", "wo")
_MLA_REST = ("w_dq", "q_norm", "w_dkv", "kv_norm", "w_kr")


def mla_forward(p: MLAAttention, cfg: LMConfig, x: torch.Tensor, *, positions=None,
                mesh=None):
    """Full-sequence MLA. x [B,S,D] -> [B,S,D]; on ``mesh``'s model axis
    the rank's heads (see the module docstring)."""
    m = cfg.mla
    b, s, _ = x.shape
    axis = _heads_axis(p, _MLA_HEADS, (cfg.n_heads,), mesh)
    w = weights(p, mesh, _MLA_HEADS, local=axis is not None)
    vars(w).update(vars(weights(p, mesh, _MLA_REST, local=True)))
    lat_q = mesh.model if model_split(p, ("w_dq",), mesh) else None
    lat_kv = mesh.model if model_split(p, ("w_dkv",), mesh) else None
    h = w.w_uq.shape[1] // (m.qk_nope_dim + m.qk_rope_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(w, cfg, x, positions, axis, lat_q)
    c, k_rope = _mla_latent(w, cfg, x, positions, axis, lat_kv)
    scale = _scale(m.qk_nope_dim + m.qk_rope_dim)
    if _use_chunked(s):
        out = _mla_chunked(w, cfg, q_nope, q_rope, c, k_rope, scale)
    else:
        k_nope = (c @ w.w_uk).reshape(b, s, h, m.qk_nope_dim)
        v = (c @ w.w_uv).reshape(b, s, h, m.v_head_dim)
        scores = (
            torch.einsum("bshe,bthe->bhst", q_nope, k_nope)
            + torch.einsum("bshe,bte->bhst", q_rope, k_rope)
        ).to(torch.float32) * scale
        scores = scores + torch.where(causal_mask(s, device=x.device), 0.0, _NEG)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhst,bthe->bshe", probs, v)
    return reduce_from_model(out.reshape(b, s, h * m.v_head_dim) @ w.wo, axis)


def _mla_chunked(p: MLAAttention, cfg: LMConfig, q_nope, q_rope, c, k_rope, scale: float):
    """Streaming-softmax MLA prefill: the per-head K/V are expanded from the
    latent one chunk at a time, so neither S x S scores nor the whole
    expanded K are ever held.  The queries go ``_MLA_Q_TILE`` rows at a
    time (a score temporary is ``[B, H, tile, chunk]`` float32: 2.1 GB at
    128 heads, where all 32k rows would take 17.2 GB), and a tile stops at
    the first key chunk wholly above its diagonal.  Keys run from 0 and
    every row reads key 0, so such a chunk would leave the tile's running
    max, sum and accumulator exactly as they were: each row adds the same
    terms in the same order as the reference's one pass over all rows."""
    m = cfg.mla
    b, s, h, _ = q_nope.shape
    ch = min(_ATTN_CHUNK, s)
    tile = min(_MLA_Q_TILE, s)
    w_uk = p.w_uk.reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    w_uv = p.w_uv.reshape(m.kv_lora_rank, h, m.v_head_dim)

    def body(mx, l, acc, q_nope, q_rope, c_j, kr_j, q_pos, k_pos, w_uk, w_uv):
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

    outs = []
    for i0 in range(0, s, tile):
        i1 = min(s, i0 + tile)
        q_pos = torch.arange(i0, i1, device=c.device)
        qn, qr = q_nope[:, i0:i1], q_rope[:, i0:i1]
        mx = torch.full((b, h, i1 - i0), _NEG, dtype=torch.float32, device=c.device)
        l = torch.zeros((b, h, i1 - i0), dtype=torch.float32, device=c.device)
        acc = torch.zeros((b, h, i1 - i0, m.v_head_dim), dtype=torch.float32, device=c.device)
        for j in range(s // ch):
            if j * ch >= i1:  # every later key lies above the tile's last row
                break
            c_j, kr_j = c[:, j * ch:(j + 1) * ch], k_rope[:, j * ch:(j + 1) * ch]
            k_pos = j * ch + torch.arange(ch, device=c.device)
            mx, l, acc = _chunk_step(body, mx, l, acc, qn, qr, c_j, kr_j, q_pos, k_pos,
                                     w_uk, w_uv)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(q_nope.dtype))
    return torch.cat(outs, dim=1)


def init_mla_cache(cfg: LMConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device="cuda") -> dict:
    return _zeros_cache(cache_shapes(cfg, batch, cache_len), dtype, device)


def mla_decode(p: MLAAttention, cfg: LMConfig, x: torch.Tensor, cache: dict, pos, *,
               mesh=None, time_split: bool = False):
    """Absorbed-weight decode: score against the cached latent directly.
    The latent is written in place at ``pos``, which must lie inside the
    cache (the reference's ``dynamic_update_slice`` would clamp it).  On
    ``mesh`` (see the module docstring) the rank's heads, and with
    ``time_split`` the rank's slots of a latent cache split in time."""
    m = cfg.mla
    b, s, _ = x.shape
    pos = int(pos)
    axis = _heads_axis(p, _MLA_HEADS, (cfg.n_heads,), mesh)
    w = weights(p, mesh, _MLA_HEADS, local=axis is not None)
    vars(w).update(vars(weights(p, mesh, _MLA_REST, local=True)))
    lat_q = mesh.model if model_split(p, ("w_dq",), mesh) else None
    lat_kv = mesh.model if model_split(p, ("w_dkv",), mesh) else None
    tm = _time_axis(mesh, time_split)
    t_loc = cache["c"].shape[1]
    t = t_loc * (1 if tm is None else tm.world_size)
    if not 0 <= pos <= t - s:
        raise ValueError(f"mla_decode: position {pos} outside a cache of {t}")
    h = w.w_uk.shape[1] // m.qk_nope_dim  # the rank's heads
    positions = torch.full((b, 1), pos, device=x.device)
    q_nope, q_rope = _mla_q(w, cfg, x, positions, axis, lat_q)
    c_new, k_rope_new = _mla_latent(w, cfg, x, positions, axis, lat_kv)

    # absorb W_uk into the query: q_abs [B,1,H,R]
    w_uk = w.w_uk.reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope, w_uk)
    scale = _scale(m.qk_nope_dim + m.qk_rope_dim)
    if tm is None:
        cache["c"][:, pos:pos + s] = c_new
        cache["k_rope"][:, pos:pos + s] = k_rope_new
        idx = torch.arange(t, device=x.device)
    else:
        if axis is not None:  # every head's absorbed query
            (q,) = _gather_heads(axis, [torch.cat([q_abs, q_rope], dim=-1)])
            q_abs, q_rope = q.split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
        _owned_write(cache, {"c": c_new, "k_rope": k_rope_new}, pos, tm, t_loc)
        idx = tm.rank * t_loc + torch.arange(t_loc, device=x.device)
    c, k_rope = cache["c"], cache["k_rope"]
    scores = (
        torch.einsum("bshr,btr->bhst", q_abs, c)
        + torch.einsum("bshe,bte->bhst", q_rope, k_rope)
    ).to(torch.float32) * scale
    if tm is None:
        scores = scores + torch.where((idx <= pos)[None, None, None, :], 0.0, _NEG)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        # attend over the latent, then absorb W_uv on the way out
        o_lat = torch.einsum("bhst,btr->bshr", probs, c)
    else:
        mx, pr, l = _partial(scores, idx <= pos)
        o = torch.einsum("bhst,btr->bhsr", pr.to(c.dtype), c).float()
        o_lat = _merge_partials(tm, mx, l, o).permute(0, 2, 1, 3).to(x.dtype)  # [B,s,H,R]
        o_lat = _rank_heads(o_lat, axis, 2)
    w_uv = w.w_uv.reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bshr,rhe->bshe", o_lat, w_uv).reshape(b, s, h * m.v_head_dim)
    return reduce_from_model(out @ w.wo, axis), cache
