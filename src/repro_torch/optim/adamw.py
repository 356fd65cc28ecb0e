"""AdamW with global-norm clipping (``repro.optim.adamw`` counterpart).

The reference's rule, leaf by leaf, on a module's parameters: a float32
global gradient norm, the clip ``min(1, clip_norm / max(gnorm, 1e-9))``,
bias correction by ``count``, weight decay only on tensors with
``ndim >= 2``, the update computed in float32 and cast back to the
parameter's dtype and the moments' (``moment_dtype``: float32, or bfloat16
to halve the optimizer's bytes).

``torch.optim.AdamW`` is not this rule: it decays every tensor, clips
nowhere and updates a bfloat16 parameter in bfloat16.

The state is ``{"mu": {name: tensor}, "nu": {name: tensor}, "count":
int32 scalar}`` keyed by the module's parameter names, every parameter
included: one that gets no gradient (MoE's ``router_bias``) takes the
reference's zero-gradient update, which moves nothing.

On a mesh (a module ``dist.sharding.place`` sharded) the moments take the
shape of the rank's shard, the global norm sums each leaf's local squares
and all-reduces them over the axes that split that leaf
(``Placement.global_norm``: a replicated leaf counts once), so the clip
reads the whole gradient's norm, and weight decay follows the parameter's
``ndim``, which a shard keeps.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.dist.sharding import placement_of


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32


def adamw_init(model: nn.Module, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` for every parameter of
    ``model``, on its device, and a zero step count."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
                for n, p in params.items()}

    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    """The float32 norm over every gradient (None counts as zero)."""
    total = None
    for g in grads:
        if g is None:
            continue
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        raise ValueError("global_norm: no gradient")
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(model: nn.Module, grads: dict, state: dict, cfg: AdamWConfig) -> torch.Tensor:
    """One AdamW step: ``model``'s parameters and ``state`` are updated in
    place from ``grads`` (parameter name -> gradient, or None for a
    parameter that got none); returns the pre-clip float32 gradient norm."""
    params = dict(model.named_parameters())
    if set(grads) - set(params):
        raise KeyError(f"gradients for no parameter: {sorted(set(grads) - set(params))}")
    count = state["count"] + 1
    placed = placement_of(model)
    gnorm = global_norm(grads.values()) if placed is None else placed.global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    cf = count.to(torch.float32)
    bc1 = 1 - cfg.b1 ** cf
    bc2 = 1 - cfg.b2 ** cf
    for name, p in params.items():
        mu, nu = state["mu"][name], state["nu"][name]
        g = grads.get(name)
        if g is None:
            g = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        g = g.to(torch.float32) * scale
        mu32 = cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * g
        nu32 = cfg.b2 * nu.to(torch.float32) + (1 - cfg.b2) * g * g
        step = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        if p.ndim >= 2:  # no decay on norms, biases or router buffers
            step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - cfg.lr * step)
        mu.copy_(mu32)
        nu.copy_(nu32)
    state["count"] = count
    return gnorm
