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
layers' inputs and recomputes each layer.

``mesh=`` (the loss and the forward; ``launch.mesh.make_mesh``) runs the
model as ``dist.sharding.place`` laid it out, the behaviour of the
reference's rule tables and ``constrain`` calls: the tokens are one data
rank's share of the global batch (the MoE layers' dispatch groups are the
global batch's, ``models.moe``), replicated over the ``model`` axis, and
so is the residual stream.  On the model axis, attention runs the rank's
heads (``models.attention``), ``DenseMLP`` is column-parallel
(``w_gate``/``w_up``) then row-parallel (``w_down``) with one sum over the
axis, the MoE layers run the rank's experts, ``embed`` is a vocab-parallel
lookup (a masked gather of the rank's rows, summed over the axis), the
head gives the rank's vocab block of the logits, and
``cross_entropy_loss`` reads them there (the max and the sum of
exponentials all-reduced, the target logit from the rank that owns it).
FSDP shards are gathered over the data axis where a layer reads them, and
their gradients reduce-scattered back.  A layer whose spec ``fit_specs``
left whole takes the replicated path.  None, the default, is one rank.

Decode on a mesh (``lm_decode_step(..., mesh=, cache_spec=)``): the cache
is placed by the reference's ``cache_spec`` (``[L, B, T, ...]``: the batch
over the batch axes where they divide it, the time axis over ``model``
unless ``REPRO_NO_SPLITKV`` is set, fitted by ``fit_specs``;
``init_lm_cache(..., mesh=)`` allocates the rank's shard alone); the step
takes the rank's rows of the tokens (replicated over ``model``) through
the vocab-parallel lookup, each layer's split-KV attention
(``models.attention``), the tensor- and expert-parallel MLP and MoE, and
the vocab-parallel logits, gathered whole for the argmax.
"""

from __future__ import annotations

import os

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.dist.sharding import (
    axis_size,
    copy_to_model,
    dp_axes,
    fit_specs,
    mesh_sizes,
    gather_from_model,
    gathered_matmul,
    model_split,
    reduce_from_model,
    weights,
)
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    cross_entropy_loss,
    init_dense,
    model_device,
    rms_norm,
    swiglu,
)
from repro_torch.models.moe import MoE, expert_loads, moe_ffn_groups


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


_MLP = ("w_gate", "w_up", "w_down")


def mlp_forward(m: DenseMLP, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """SwiGLU; on ``mesh``'s model axis column- then row-parallel, the
    partial sums summed over the axis."""
    axis = mesh.model if model_split(m, _MLP, mesh) else None
    w = weights(m, mesh, _MLP, local=axis is not None)
    return reduce_from_model(swiglu(copy_to_model(x, axis), w.w_gate, w.w_up, w.w_down),
                             axis)


def _layer_fwd(cfg: LMConfig, layer: Layer, x, *, is_moe: bool, backend=None, mesh=None):
    hn = rms_norm(x, layer.attn_norm)
    if cfg.mla:
        h = x + attn.mla_forward(layer.attn, cfg, hn, mesh=mesh)
    else:
        h = x + attn.gqa_forward(layer.attn, cfg, hn, backend=backend, mesh=mesh)
    hn = rms_norm(h, layer.ffn_norm)
    if is_moe:
        b, s, d = hn.shape
        y, aux, density = moe_ffn_groups(layer.moe, cfg.moe, hn.reshape(b * s, d), mesh=mesh)
        return h + y.reshape(b, s, d), (aux, density)
    return h + mlp_forward(layer.mlp, hn, mesh), (None, None)


def vocab_axis(model: Transformer, mesh):
    """``mesh``'s model axis where it splits the vocab (``embed``'s rows),
    else None."""
    return mesh.model if model_split(model, ("embed",), mesh) else None


def embed_tokens(model: Transformer, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """tokens -> their embeddings; on a model axis that splits the vocab, a
    masked gather of the rank's rows summed over the axis."""
    axis = vocab_axis(model, mesh)
    table = weights(model, mesh, ("embed",), local=axis is not None).embed
    if axis is None:
        return table[tokens]
    local = tokens.long() - axis.rank * table.shape[0]
    hit = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(hit, local, 0)]
    return reduce_from_model(torch.where(hit[..., None], rows, 0), axis)


def lm_hidden(model: Transformer, tokens: torch.Tensor, *, backend: str | None = None,
              mesh=None):
    """tokens [B,S] -> (hidden [B,S,D], aux scalar, moe loads [L_moe, E] or
    None); under a ``mesh`` of data ranks, tokens are this rank's rows,
    aux its groups' mean, and the loads the global batch's (one all-gather
    for every layer)."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, mesh)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    loads = None
    remat = cfg.remat and torch.is_grad_enabled()
    for _, layers, is_moe in model.stacks():
        auxs, densities = [], []
        for layer in layers:
            if remat:
                x, (a, density) = checkpoint(_layer_fwd, cfg, layer, x, is_moe=is_moe,
                                             backend=backend, mesh=mesh, use_reentrant=False)
            else:
                x, (a, density) = _layer_fwd(cfg, layer, x, is_moe=is_moe, backend=backend,
                                             mesh=mesh)
            auxs.append(a)
            densities.append(density)
        if is_moe:
            aux = aux + torch.stack(auxs).sum()
            loads = expert_loads(torch.stack(densities), mesh)
    return x, aux, loads


def _logits(model: Transformer, h: torch.Tensor, mesh=None) -> torch.Tensor:
    """The logits of hidden states ``h``: on a model axis that splits the
    vocab, the rank's block (``gather_logits`` puts them together)."""
    h = rms_norm(h, model.final_norm)
    axis = vocab_axis(model, mesh)
    if model.cfg.tie_embeddings:
        head = weights(model, mesh, ("embed",), local=axis is not None).embed.T
    else:
        head = weights(model, mesh, ("head",), local=axis is not None).head
    return copy_to_model(h, axis) @ head


def gather_logits(model: Transformer, logits: torch.Tensor, mesh=None) -> torch.Tensor:
    """``_logits``' blocks laid end to end: the whole vocab on every rank."""
    return gather_from_model(logits, vocab_axis(model, mesh), dim=-1)


def lm_forward(model: Transformer, tokens: torch.Tensor, *, backend: str | None = None):
    """-> (logits [B,S,V], aux)."""
    h, aux, _ = lm_hidden(model, tokens, backend=backend)
    return _logits(model, h), aux


def lm_loss_and_stats(model: Transformer, tokens: torch.Tensor, *,
                      backend: str | None = None, mesh=None):
    """(loss, stats) for tokens [B, S+1]: next-token CE, the MoE aux loss
    unless the aux-free bias balances, and DeepSeek-V3's MTP loss; stats
    carry the per-layer expert loads.  Under a ``mesh`` (``lm_hidden``) the
    loss is this rank's rows' and the loads the global batch's."""
    cfg = model.cfg
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    h, aux, loads = lm_hidden(model, inp, backend=backend, mesh=mesh)
    vocab = vocab_axis(model, mesh)
    loss = cross_entropy_loss(_logits(model, h, mesh), labels, axis=vocab)
    if cfg.moe and not cfg.moe.aux_free_bias:
        loss = loss + cfg.moe.router_aux_weight * aux
    if cfg.mtp_depth:
        # MTP (depth 1): predict t+2 from h_t and the embedding of token t+1
        # through one more block; position 0 of the shifted stream is
        # padding, masked out of the loss, so the block runs at length S
        mtp = model.mtp
        emb_next = embed_tokens(model, torch.roll(inp, -1, dims=1), mesh)
        proj = weights(mtp, mesh, ("proj",), local=True).proj
        z = gathered_matmul(torch.cat([h, emb_next], dim=-1), proj,
                            mesh.model if model_split(mtp, ("proj",), mesh) else None)
        z, _ = _layer_fwd(cfg, mtp.layer, z, is_moe=False, backend=backend, mesh=mesh)
        mtp_logits = _logits(model, rms_norm(z, mtp.norm), mesh)
        loss = loss + 0.3 * cross_entropy_loss(mtp_logits[:, :-1], labels[:, 1:], axis=vocab)
    return loss, {"moe_loads": loads}


def lm_loss(model: Transformer, tokens: torch.Tensor, *, backend: str | None = None):
    """Next-token CE (+ MoE aux + MTP loss).  tokens [B, S+1]."""
    return lm_loss_and_stats(model, tokens, backend=backend)[0]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def cache_spec(cfg: LMConfig, batch: int, cache_len: int, mesh) -> tuple:
    """The reference's decode ``cache_spec`` for ``[L, B, T, ...]`` leaves,
    fitted to ``mesh`` (a ``HostMesh`` or a ``MeshLayout``): ``(None, the
    batch axes where they divide B else None, "model" where it divides the
    cache's T and ``REPRO_NO_SPLITKV`` is unset, else None)``; the trailing
    dims are whole."""
    if cfg.sliding_window is not None:
        cache_len = min(cache_len, cfg.sliding_window)
    sizes = mesh_sizes(mesh)
    dp = dp_axes(mesh)
    t_axis = None if os.environ.get("REPRO_NO_SPLITKV") else "model"
    spec = (None, dp if batch % axis_size(sizes, dp) == 0 else None, t_axis)
    return fit_specs({"c": spec}, {"c": (1, batch, cache_len)}, mesh)["c"]


def init_lm_cache(cfg: LMConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                  device="cuda", *, mesh=None) -> dict:
    """Per-stack caches with a leading layer axis (``[L, B, T, ...]``, the
    reference's layout).  SWA archs get ring buffers of the window's size.
    On ``mesh``, the rank's shard of each under ``cache_spec``."""
    if cfg.sliding_window is not None:
        cache_len = min(cache_len, cfg.sliding_window)
    if mesh is not None:
        sizes = mesh_sizes(mesh)
        _, b_ax, t_ax = cache_spec(cfg, batch, cache_len, mesh)
        batch //= axis_size(sizes, b_ax) if b_ax else 1
        cache_len //= axis_size(sizes, t_ax) if t_ax else 1
    one = attn.cache_shapes(cfg, batch, cache_len)
    n_dense = cfg.first_k_dense if cfg.moe else cfg.n_layers
    return {
        key: attn._zeros_cache({name: (n, *shape) for name, shape in one.items()},
                               dtype, device)
        for key, n in (("dense", n_dense), ("moe", cfg.n_moe_layers)) if n
    }


def lm_decode_step(model: Transformer, cache: dict, tokens: torch.Tensor, pos, *,
                   mesh=None, cache_spec: tuple | None = None):
    """One decode step: tokens [B,1], pos an int -> (logits [B,1,V], cache),
    the cache written in place.  On ``mesh``: ``tokens`` are the rank's
    rows where ``cache_spec`` splits the batch (else the whole batch), the
    cache the rank's shard under ``cache_spec`` (None: batch and time
    whole), and the logits the rank's rows over the whole vocab."""
    cfg = model.cfg
    dec = attn.mla_decode if cfg.mla else attn.gqa_decode
    split = cache_spec is not None and cache_spec[2] is not None
    replicated = mesh is not None and (cache_spec is None or cache_spec[1] is None)
    x = embed_tokens(model, tokens, mesh)
    for key, layers, is_moe in model.stacks():
        for i, layer in enumerate(layers):
            lcache = {name: t[i] for name, t in cache[key].items()}
            a, _ = dec(layer.attn, cfg, rms_norm(x, layer.attn_norm), lcache, pos, mesh=mesh,
                       time_split=split)
            h = x + a
            hn = rms_norm(h, layer.ffn_norm)
            if is_moe:
                b, s, d = hn.shape
                y, _, _ = moe_ffn_groups(layer.moe, cfg.moe, hn.reshape(b * s, d), mesh=mesh,
                                         replicated=replicated)
                x = h + y.reshape(b, s, d)
            else:
                x = h + mlp_forward(layer.mlp, hn, mesh)
    return gather_logits(model, _logits(model, x, mesh), mesh), cache
