"""Shared model components: norms, RoPE, initializers, MLP blocks
(``repro.models.common`` counterpart).

Weights keep the reference's ``[d_in, d_out]`` layout (``x @ w``).  The
initializer draws from an explicit ``torch.Generator``: the values differ
from the JAX package's ``jax.random`` draws, so parameters are carried
across by ``repro_torch.convert`` where two runs must agree.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import reduce_from_model


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    # the variance accumulates in float32, as the reference's
    # preferred_element_type asks
    xf = x.to(torch.float32)
    ss = torch.einsum("...d,...d->...", xf, xf)
    var = ss[..., None] / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale


def model_device(device) -> torch.device:
    """The device a model is built on: the card unless the caller asks for
    the CPU; a CUDA request without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a model on CUDA was requested but CUDA is not available; pass device='cpu'"
        )
    return device


def init_dense(
    generator: torch.Generator | None, d_in: int, d_out: int, dtype=torch.bfloat16
) -> torch.Tensor:
    """``[d_in, d_out]`` normal weights scaled by ``1/sqrt(d_in)``, drawn in
    float32 from ``generator`` on its device (the CPU when it is None) and
    cast to ``dtype``.  The draw is scaled in place (the same bits as
    ``w * scale``), so the float32 draw is the only transient: a
    DeepSeek-V3 expert tensor is 3.76e9 elements, 15 GB in float32."""
    scale = 1.0 / math.sqrt(d_in)
    device = generator.device if generator is not None else None
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


def rope_angles(positions: torch.Tensor, d_head: int, theta: float = 10000.0):
    """positions [*, S] -> (cos, sin) each [*, S, d_head/2] (float32)."""
    half = d_head // 2
    freq = 1.0 / (
        theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    )
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; cos/sin [..., S, 1, D/2] or broadcastable."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor):
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", F.silu(g) * u, w_down)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float = 0.0,
                       axis=None):
    """Mean next-token CE in float32; logits [..., V], labels [...] int.
    ``axis`` (a ``PartitionMesh``): the model axis that splits the vocab,
    ``logits`` the rank's block ``[..., V/T]`` (rank r holds ids ``[r*V/T,
    (r+1)*V/T)``): the max and the sum of exponentials are all-reduced
    over it and the target logit comes from the rank that owns it."""
    logits = logits.to(torch.float32)
    if axis is None or axis.world_size == 1:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    else:
        v = logits.shape[-1]
        top = axis.all_reduce(logits.detach().amax(dim=-1), op="max")
        sumexp = reduce_from_model(torch.exp(logits - top[..., None]).sum(dim=-1), axis)
        lse = top + torch.log(sumexp)
        local = labels.long() - axis.rank * v
        hit = (local >= 0) & (local < v)
        ll = torch.take_along_dim(logits, torch.where(hit, local, 0)[..., None], dim=-1)[..., 0]
        ll = reduce_from_model(torch.where(hit, ll, 0.0), axis)
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse**2)
    return loss


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the k largest along the last axis, ties to
    the lower index, as ``jax.lax.top_k`` (``torch.topk`` makes no such
    promise): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
