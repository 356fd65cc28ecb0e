"""Mixture-of-Experts FFN with blockwise sort-based dispatch
(``repro.models.moe`` counterpart).

Dispatch keeps the reference's dropping formulation: tokens are reshaped to
``[G, T/G, D]`` groups, each group top-k routes, sorts its (token, k) pairs
by expert and packs per-expert buffers of static capacity
``C = ceil4(T_loc * top_k / E * capacity_factor)`` (at least 4); a pair
past its expert's capacity is dropped.  Router options: softmax over the
top-k logits (Mixtral) and the DeepSeek-V3 aux-loss-free selection bias.

Three orders decide which pairs drop, and each follows the reference:

  * top-k breaks ties by the lower expert index (``jax.lax.top_k``): a
    stable descending sort, since ``torch.topk`` makes no such promise;
  * pairs are ordered by expert with a stable argsort (``jnp.argsort``);
  * ``_capacity``'s float-then-``int`` arithmetic is copied as it is.

The combine is a gather, never an atomic scatter: each (token, k) pair
reads its slot's weighted output (nothing if dropped), and a token's k
terms are added in ascending slot order, the order of the reference's
scatter-add, so two calls give the same bits on any device.

Data-parallel ranks (``mesh=``, a mesh whose batch axes, pod x data, span
D > 1 ranks) run the global batch's dispatch groups: the reference's
``_n_groups`` sees the global token count (GSPMD shards the groups over the
batch axes, not the tokens), so a rank holding T tokens runs ``G / D`` of
the ``G = _n_groups(T * D)`` groups -- its own rows' groups, at the global
group size and capacity -- and the drops, the aux loss's groups and the
loads are the one-rank run's.  ``moe_ffn_groups`` returns the rank's
per-group densities; ``expert_loads`` gathers every rank's over the batch
axes and sums all G groups in global order, so the load (and the router
bias it moves) equals the one-rank load bit for bit.  Where the batch is
replicated over the batch ranks (a decode batch they cannot split,
``replicated=True``), every rank runs all the groups of its tokens.

On a ``model`` axis of T ranks (the module placed by
``dist.sharding.place``: the reference's ``constrain`` calls pin the
expert buffers to it) the experts are split, E/T a rank, and the tokens
replicated: every model rank routes them all (the same drops, densities
and loads), runs its own experts on their slots, and all-gathers the
experts' outputs over the axis; the combine then reads every slot in the
one-rank order, so it adds the same terms in the same order.  The router
is FSDP-sharded over ``data`` and ``router_bias`` replicated; shared
experts are column- then row-parallel, as ``DenseMLP``.  Where E (or the
shared width) does not split over T, the layer computes with its weights
gathered whole.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.dist.sharding import (
    copy_to_model,
    dp_size,
    gather_from_model,
    model_split,
    reduce_from_model,
    weights,
)
from repro_torch.models.common import init_dense, top_k


class SharedExperts(nn.Module):
    def __init__(self, d_model: int, fs: int, generator, dtype):
        super().__init__()
        self.w_gate = nn.Parameter(init_dense(generator, d_model, fs, dtype))
        self.w_up = nn.Parameter(init_dense(generator, d_model, fs, dtype))
        self.w_down = nn.Parameter(init_dense(generator, fs, d_model, dtype))


class MoE(nn.Module):
    """The reference's ``init_moe_params`` leaves: ``router [D, E]``
    (float32), ``we_gate``/``we_up [E, D, F]``, ``we_down [E, F, D]``,
    ``router_bias [E]`` (float32, moved by ``update_router_bias``, never by
    gradients) and ``shared`` where the config has them."""

    def __init__(self, d_model: int, cfg: MoEConfig, *,
                 generator: torch.Generator | None = None, dtype=torch.bfloat16):
        super().__init__()
        e, f = cfg.n_experts, cfg.d_ff_expert
        self.router = nn.Parameter(init_dense(generator, d_model, e, torch.float32))
        self.we_gate = nn.Parameter(init_dense(generator, d_model, e * f, dtype).reshape(e, d_model, f))
        self.we_up = nn.Parameter(init_dense(generator, d_model, e * f, dtype).reshape(e, d_model, f))
        self.we_down = nn.Parameter(init_dense(generator, f, e * d_model, dtype).reshape(e, f, d_model))
        if cfg.aux_free_bias:
            dev = generator.device if generator is not None else None
            self.router_bias = nn.Parameter(
                torch.zeros(e, dtype=torch.float32, device=dev), requires_grad=False)
        if cfg.n_shared:
            self.shared = SharedExperts(d_model, f * cfg.n_shared, generator, dtype)


DISPATCH_GROUPS = 32  # target group count; actual = largest divisor of T
_EXPERTS = ("we_gate", "we_up", "we_down")
_SHARED = ("w_gate", "w_up", "w_down")


def _n_groups(t: int) -> int:
    g = min(DISPATCH_GROUPS, t)
    while t % g:
        g -= 1
    return g


def dispatch_groups(t: int, mesh=None) -> int:
    """The dispatch groups of a rank holding ``t`` of the global batch's
    tokens: ``_n_groups`` of the global count, split evenly over the batch
    ranks (a group straddling two ranks raises)."""
    d = 1 if mesh is None else dp_size(mesh)
    g = _n_groups(t * d)
    if g % d:
        raise ValueError(
            f"{t * d} tokens make {g} dispatch groups, which {d} data ranks cannot "
            "split evenly")
    return g // d


def _capacity(t_loc: int, cfg: MoEConfig) -> int:
    c = int(t_loc * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, (c + 3) // 4 * 4)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table [G, R, D]``, ``idx [G, N]`` -> ``[G, N, D]``: each group's rows
    by index, one gather over the flattened groups."""
    g, r, d = table.shape
    flat = (idx + torch.arange(g, device=idx.device)[:, None] * r).reshape(-1)
    return table.reshape(g * r, d).index_select(0, flat).reshape(g, -1, d)


class Routing(NamedTuple):
    """One ``moe_ffn`` call's dispatch: ``G`` groups of ``T_loc`` tokens, per
    expert capacity ``cap``; pairs are (token, k) in token-major order."""

    g: int
    t_loc: int
    cap: int
    logits: torch.Tensor  # [G, T_loc, E] float32 router logits
    top_idx: torch.Tensor  # [G, T_loc, K] each pair's expert
    probs: torch.Tensor  # [G, T_loc, K] softmax over the top-k logits
    order: torch.Tensor  # [G, T_loc*K] pairs sorted by expert, stably
    slot: torch.Tensor  # [G, T_loc*K] each sorted pair's slot; E*cap if dropped
    keep: torch.Tensor  # [G, T_loc*K] each sorted pair kept

    def kept(self) -> torch.Tensor:
        """``[T, K]`` bool: pair (token, k) holds a slot."""
        return torch.empty_like(self.keep).scatter_(1, self.order, self.keep).reshape(
            self.g * self.t_loc, -1)


def route(p: MoE, cfg: MoEConfig, x: torch.Tensor, mesh=None, *,
          replicated: bool = False) -> Routing:
    """Top-k routing and the capacity drop rule for x [T, D] (this rank's
    tokens under ``mesh``; all of them where ``replicated``)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = dispatch_groups(t, None if replicated else mesh)
    t_loc = t // g
    cap = _capacity(t_loc, cfg)
    dev = x.device
    xg = x.reshape(g, t_loc, d)

    # float32 router logits from the inputs' values (the reference's
    # preferred_element_type): the router is cast to x's dtype first
    logits = xg.to(torch.float32) @ p.router.to(x.dtype).to(torch.float32)
    # the aux-free bias steers selection only
    sel_logits = logits + p.router_bias if hasattr(p, "router_bias") else logits
    _, top_idx = top_k(sel_logits, k)  # [G, T_loc, K]
    probs = torch.softmax(torch.take_along_dim(logits, top_idx, dim=2), dim=-1)

    n_pairs = t_loc * k
    pair_expert = top_idx.reshape(g, n_pairs)
    order = torch.argsort(pair_expert, dim=1, stable=True)
    se = torch.take_along_dim(pair_expert, order, dim=1)
    starts = torch.searchsorted(se, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos_in_e = torch.arange(n_pairs, device=dev)[None] - torch.take_along_dim(starts, se, dim=1)
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, e * cap)  # drops -> scratch slot
    return Routing(g, t_loc, cap, logits, top_idx, probs, order, slot, keep)


def moe_ffn(p: MoE, cfg: MoEConfig, x: torch.Tensor):
    """x [T, D] -> (y [T, D], aux_loss scalar, expert load fraction [E])."""
    y, aux, density = moe_ffn_groups(p, cfg, x)
    return y, aux, expert_loads(density)


def moe_ffn_groups(p: MoE, cfg: MoEConfig, x: torch.Tensor, *, mesh=None,
                   replicated: bool = False):
    """x [T, D] -> (y [T, D], aux_loss scalar, the dispatch groups' expert
    densities [G, E], detached; ``expert_loads`` makes them the load).
    Under a ``mesh``, x is this batch rank's tokens, and the aux loss and the
    densities are its G/D groups' (or, ``replicated``, x is the whole batch
    on every batch rank, and its groups all of them)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    axis = mesh.model if model_split(p, _EXPERTS, mesh) else None
    w = weights(p, mesh, ("router",) + _EXPERTS, local=axis is not None)
    if hasattr(p, "router_bias"):
        w.router_bias = p.router_bias
    r = route(w, cfg, x, mesh, replicated=replicated)
    g, t_loc, cap = r.g, r.t_loc, r.cap
    dev = x.device

    # Switch-style load-balance aux (zero-weighted under the aux-free bias)
    full_probs = torch.softmax(r.logits, dim=-1)
    density = torch.zeros((g, e), dtype=torch.float32, device=dev).scatter_add_(
        1, r.top_idx.reshape(g, -1), torch.ones((g, t_loc * k), dtype=torch.float32, device=dev)
    ) / (t_loc * k)
    importance = full_probs.mean(dim=1)
    aux = e * torch.mean(torch.sum(density * importance, dim=-1))

    # ---- blockwise sort dispatch, batched over groups ----
    pair_token = torch.arange(t_loc, device=dev).repeat_interleave(k)[None].expand(g, -1)
    st = torch.take_along_dim(pair_token, r.order, dim=1)
    sp = torch.take_along_dim(r.probs.reshape(g, -1), r.order, dim=1)
    # slot -> token indirection (t_loc = "empty, read the zero pad row");
    # kept slots are unique, and every write to the scratch slot is the same
    token_of_slot = torch.full((g, e * cap + 1), t_loc, dtype=torch.int64, device=dev)
    token_of_slot.scatter_(1, r.slot, torch.where(r.keep, st, t_loc))
    token_of_slot = token_of_slot[:, :-1]
    prob_of_slot = torch.zeros((g, e * cap + 1), dtype=torch.float32, device=dev)
    prob_of_slot.scatter_(1, r.slot, torch.where(r.keep, sp, 0.0))
    prob_of_slot = prob_of_slot[:, :-1]

    # the rank's experts' slots (all of them off a model axis)
    e_loc = w.we_gate.shape[0]
    own = token_of_slot
    if axis is not None:
        own = own.reshape(g, e, cap)[:, axis.rank * e_loc:(axis.rank + 1) * e_loc]
        own = own.reshape(g, e_loc * cap)
    xin = copy_to_model(x, axis)
    xg_pad = torch.cat([xin.reshape(g, t_loc, d), x.new_zeros((g, 1, d))], dim=1)
    xe = _rows(xg_pad, own).reshape(g, e_loc, cap, d)

    gate = torch.einsum("gecd,edf->gecf", xe, w.we_gate)
    up = torch.einsum("gecd,edf->gecf", xe, w.we_up)
    ye = torch.einsum("gecf,efd->gecd", F.silu(gate) * up, w.we_down)
    ye = gather_from_model(ye, axis, dim=1).reshape(g, e * cap, d)
    del xe, gate, up
    contrib = ye * prob_of_slot[..., None].to(x.dtype)

    # combine by gather: each pair's slot in its (token, k) place; a token's
    # slots ascending, a dropped pair on the zero row appended at e * cap
    slot_of_pair = torch.empty_like(r.slot).scatter_(1, r.order, r.slot)
    slot_of_pair = slot_of_pair.reshape(g, t_loc, k).sort(dim=-1).values
    contrib = torch.cat([contrib, contrib.new_zeros((g, 1, d))], dim=1)
    yg = None
    for j in range(k):
        term = _rows(contrib, slot_of_pair[:, :, j])
        yg = term if yg is None else yg + term
    y = yg.reshape(t, d)

    if cfg.n_shared:
        s_axis = mesh.model if model_split(p.shared, _SHARED, mesh) else None
        s = weights(p.shared, mesh, _SHARED, local=s_axis is not None)
        xs = copy_to_model(x, s_axis)
        y = y + reduce_from_model((F.silu(xs @ s.w_gate) * (xs @ s.w_up)) @ s.w_down, s_axis)

    return y, aux, density.detach()


def expert_loads(densities: torch.Tensor, mesh=None) -> torch.Tensor:
    """Group densities ``[..., G, E]`` (stacked over layers, say) -> the load
    fraction ``[..., E]``: the groups summed in order, times float32(1/G),
    which is how jnp.mean rounds, so equal routing gives equal bits.  Under
    a ``mesh`` each batch rank holds ``G/D`` groups: one all-gather along the
    batch axes puts all G in global order first, as one rank sums them."""
    if mesh is not None:
        every = mesh.batch.all_gather(densities)  # [D, ..., G/D, E]
        every = torch.movedim(every, 0, -3)
        densities = every.reshape(*every.shape[:-3], -1, every.shape[-1])
    g = densities.shape[-2]
    load = densities[..., 0, :]
    for i in range(1, g):
        load = load + densities[..., i, :]
    return load * float(np.float32(1.0 / g))


def update_router_bias(bias: torch.Tensor, load: torch.Tensor, lr: float = 1e-3) -> torch.Tensor:
    """DeepSeek-V3 aux-free balancing: nudge the per-expert selection bias
    against the observed load fraction (outside the gradient path; ``load``
    is ``moe_ffn``'s, possibly stacked over layers -- the update
    broadcasts)."""
    target = load.mean(dim=-1, keepdim=True)
    return bias + lr * torch.sign(target - load)
