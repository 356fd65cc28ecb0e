"""Decoder-only LM for the five transformer architectures: dense GQA
(granite, mistral-nemo, tinyllama), MoE with a sliding window (mixtral) and
MLA with MoE and MTP (deepseek-v3) (``repro.models.transformer``
counterpart: the forward and loss the train step differentiates, and
decode).

``Transformer`` holds the reference's parameter tree: ``embed``, ``head``
(absent under tied embeddings), ``final_norm``, ``dense_layers`` and
``moe_layers`` (``nn.ModuleList``s: the reference stacks them on a leading
layer axis for ``lax.scan``; DeepSeek's leading dense layers come first),
and ``mtp``.  The functions below take the model and read its config.

``backend`` selects the attention kernel (``models.attention``): None runs
the CUDA flash kernel on a card for a forward without gradients and the
plain paths otherwise (the kernel has no backward); ``"torch"`` the plain
paths anywhere.  Under ``cfg.remat``, where a gradient is asked for, each
trunk layer runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of the scanned layer body): the backward keeps only the
layers' inputs and recomputes each layer.  The reference's ``constrain``
calls (mesh placement) mean nothing on one device and are dropped.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    cross_entropy_loss,
    init_dense,
    model_device,
    rms_norm,
    swiglu,
)
from repro_torch.models.moe import MoE, moe_ffn


def _ones(d: int, dtype, generator) -> nn.Parameter:
    dev = generator.device if generator is not None else None
    return nn.Parameter(torch.ones(d, dtype=dtype, device=dev))


class DenseMLP(nn.Module):
    def __init__(self, cfg: LMConfig, generator, dtype):
        super().__init__()
        self.w_gate = nn.Parameter(init_dense(generator, cfg.d_model, cfg.d_ff, dtype))
        self.w_up = nn.Parameter(init_dense(generator, cfg.d_model, cfg.d_ff, dtype))
        self.w_down = nn.Parameter(init_dense(generator, cfg.d_ff, cfg.d_model, dtype))


class Layer(nn.Module):
    """``attn_norm``, ``ffn_norm``, ``attn`` (GQA or MLA) and ``mlp`` or
    ``moe``."""

    def __init__(self, cfg: LMConfig, *, is_moe: bool, generator, dtype):
        super().__init__()
        self.attn_norm = _ones(cfg.d_model, dtype, generator)
        self.ffn_norm = _ones(cfg.d_model, dtype, generator)
        self.attn = (attn.MLAAttention if cfg.mla else attn.GQAAttention)(
            cfg, generator=generator, dtype=dtype)
        if is_moe:
            self.moe = MoE(cfg.d_model, cfg.moe, generator=generator, dtype=dtype)
        else:
            self.mlp = DenseMLP(cfg, generator, dtype)


class MTP(nn.Module):
    def __init__(self, cfg: LMConfig, generator, dtype):
        super().__init__()
        self.proj = nn.Parameter(init_dense(generator, 2 * cfg.d_model, cfg.d_model, dtype))
        self.layer = Layer(cfg, is_moe=False, generator=generator, dtype=dtype)
        self.norm = _ones(cfg.d_model, dtype, generator)


class Transformer(nn.Module):
    """``Transformer(cfg)``: the reference's ``init_lm_params`` tree, drawn
    from ``generator`` on its device (the CPU when it is None) in ``dtype``
    (the router in float32), on ``device`` (the card unless the caller asks
    for the CPU)."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator | None = None,
                 device="cuda", dtype=torch.bfloat16):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        n_dense = cfg.first_k_dense if cfg.moe else cfg.n_layers
        self.embed = nn.Parameter(init_dense(generator, cfg.vocab, cfg.d_model, dtype))
        self.final_norm = _ones(cfg.d_model, dtype, generator)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(init_dense(generator, cfg.d_model, cfg.vocab, dtype))
        if n_dense:
            self.dense_layers = nn.ModuleList(
                [Layer(cfg, is_moe=False, generator=generator, dtype=dtype)
                 for _ in range(n_dense)])
        if cfg.n_moe_layers:
            self.moe_layers = nn.ModuleList(
                [Layer(cfg, is_moe=True, generator=generator, dtype=dtype)
                 for _ in range(cfg.n_moe_layers)])
        if cfg.mtp_depth:
            self.mtp = MTP(cfg, generator, dtype)
        self.to(device)

    def stacks(self):
        """``(cache key, layers, is_moe)`` for each layer stack, in order."""
        out = []
        if hasattr(self, "dense_layers"):
            out.append(("dense", self.dense_layers, False))
        if hasattr(self, "moe_layers"):
            out.append(("moe", self.moe_layers, True))
        return out


# ---------------------------------------------------------------------------
# forward (prefill) and loss
# ---------------------------------------------------------------------------


def _layer_fwd(cfg: LMConfig, layer: Layer, x, *, is_moe: bool, backend=None):
    hn = rms_norm(x, layer.attn_norm)
    if cfg.mla:
        h = x + attn.mla_forward(layer.attn, cfg, hn)
    else:
        h = x + attn.gqa_forward(layer.attn, cfg, hn, backend=backend)
    hn = rms_norm(h, layer.ffn_norm)
    if is_moe:
        b, s, d = hn.shape
        y, aux, load = moe_ffn(layer.moe, cfg.moe, hn.reshape(b * s, d))
        return h + y.reshape(b, s, d), (aux, load)
    m = layer.mlp
    return h + swiglu(hn, m.w_gate, m.w_up, m.w_down), (None, None)


def lm_hidden(model: Transformer, tokens: torch.Tensor, *, backend: str | None = None):
    """tokens [B,S] -> (hidden [B,S,D], aux scalar, moe loads [L_moe, E] or
    None)."""
    cfg = model.cfg
    x = model.embed[tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    loads = None
    remat = cfg.remat and torch.is_grad_enabled()
    for _, layers, is_moe in model.stacks():
        auxs, stack_loads = [], []
        for layer in layers:
            if remat:
                x, (a, load) = checkpoint(_layer_fwd, cfg, layer, x, is_moe=is_moe,
                                          backend=backend, use_reentrant=False)
            else:
                x, (a, load) = _layer_fwd(cfg, layer, x, is_moe=is_moe, backend=backend)
            auxs.append(a)
            stack_loads.append(load)
        if is_moe:
            aux = aux + torch.stack(auxs).sum()
            loads = torch.stack(stack_loads)
    return x, aux, loads


def _logits(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, model.final_norm)
    head = model.embed.T if model.cfg.tie_embeddings else model.head
    return h @ head


def lm_forward(model: Transformer, tokens: torch.Tensor, *, backend: str | None = None):
    """-> (logits [B,S,V], aux)."""
    h, aux, _ = lm_hidden(model, tokens, backend=backend)
    return _logits(model, h), aux


def lm_loss_and_stats(model: Transformer, tokens: torch.Tensor, *,
                      backend: str | None = None):
    """(loss, stats) for tokens [B, S+1]: next-token CE, the MoE aux loss
    unless the aux-free bias balances, and DeepSeek-V3's MTP loss; stats
    carry the per-layer expert loads."""
    cfg = model.cfg
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    h, aux, loads = lm_hidden(model, inp, backend=backend)
    loss = cross_entropy_loss(_logits(model, h), labels)
    if cfg.moe and not cfg.moe.aux_free_bias:
        loss = loss + cfg.moe.router_aux_weight * aux
    if cfg.mtp_depth:
        # MTP (depth 1): predict t+2 from h_t and the embedding of token t+1
        # through one more block; position 0 of the shifted stream is
        # padding, masked out of the loss, so the block runs at length S
        mtp = model.mtp
        emb_next = model.embed[torch.roll(inp, -1, dims=1)]
        z = torch.cat([h, emb_next], dim=-1) @ mtp.proj
        z, _ = _layer_fwd(cfg, mtp.layer, z, is_moe=False, backend=backend)
        mtp_logits = _logits(model, rms_norm(z, mtp.norm))
        loss = loss + 0.3 * cross_entropy_loss(mtp_logits[:, :-1], labels[:, 1:])
    return loss, {"moe_loads": loads}


def lm_loss(model: Transformer, tokens: torch.Tensor, *, backend: str | None = None):
    """Next-token CE (+ MoE aux + MTP loss).  tokens [B, S+1]."""
    return lm_loss_and_stats(model, tokens, backend=backend)[0]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_lm_cache(cfg: LMConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                  device="cuda") -> dict:
    """Per-stack caches with a leading layer axis (``[L, B, T, ...]``, the
    reference's layout).  SWA archs get ring buffers of the window's size."""
    if cfg.sliding_window is not None:
        cache_len = min(cache_len, cfg.sliding_window)
    one = attn.cache_shapes(cfg, batch, cache_len)
    n_dense = cfg.first_k_dense if cfg.moe else cfg.n_layers
    return {
        key: attn._zeros_cache({name: (n, *shape) for name, shape in one.items()},
                               dtype, device)
        for key, n in (("dense", n_dense), ("moe", cfg.n_moe_layers)) if n
    }


def lm_decode_step(model: Transformer, cache: dict, tokens: torch.Tensor, pos):
    """One decode step: tokens [B,1], pos an int -> (logits [B,1,V], cache),
    the cache written in place."""
    cfg = model.cfg
    dec = attn.mla_decode if cfg.mla else attn.gqa_decode
    x = model.embed[tokens]
    for key, layers, is_moe in model.stacks():
        for i, layer in enumerate(layers):
            lcache = {name: t[i] for name, t in cache[key].items()}
            a, _ = dec(layer.attn, cfg, rms_norm(x, layer.attn_norm), lcache, pos)
            h = x + a
            hn = rms_norm(h, layer.ffn_norm)
            if is_moe:
                b, s, d = hn.shape
                y, _, _ = moe_ffn(layer.moe, cfg.moe, hn.reshape(b * s, d))
                x = h + y.reshape(b, s, d)
            else:
                m = layer.mlp
                x = h + swiglu(hn, m.w_gate, m.w_up, m.w_down)
    return _logits(model, x), cache
