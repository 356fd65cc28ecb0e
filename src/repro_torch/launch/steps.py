"""Step bundles (``repro.launch.steps`` counterpart): per (architecture x
input shape), the step function, its inputs' shapes and bounds, and a
seeded state.

  * ``train`` kinds of every family, and every GNN shape: ``(state, batch)
    -> (state', {"loss", "gnorm"})``, the loss's gradient by autograd and
    one ``adamw_update``; the state is ``{"params": module, "opt":
    adamw_init(...)}``, updated in place.  LM: ``tokens [B, S+1]``, the
    loss of ``lm_loss_and_stats``, then (DeepSeek-V3) each MoE layer's
    router bias moved by its loads; moments in bfloat16 where
    ``REPRO_BF16_MOMENTS`` is set, as the reference reads it.  GNN: the
    reference's inputs, sizes and padding (``_gnn_sizes``), node
    classification over 64 classes, or a regression on per-graph targets
    (batched small graphs and the geometric models), the per-graph readout
    summed by the segment-sum kernel; no weight decay.  recsys: DeepFM's
    loss, no weight decay.
  * LM ``prefill``: the forward pass over the prompt, the next token from
    the last position only (no ``[B, S, V]`` logits); ``decode``: one token
    against a ``seq_len`` cache (``reduced``: 2 sequences, 64 slots).
  * recsys ``serve``: sigmoid scores; ``retrieval``: the top 100 (8
    reduced) of the candidates' scores.

Every step runs on the bundle's device (the card unless the caller asks
for the CPU), its kernels chosen as ``models`` chooses them: on a card the
segment-sum kernel, and the flash kernel only where no gradient is asked
for; the serving steps under ``torch.inference_mode()``.

``mesh=`` (``launch.mesh.make_mesh``: a ``(pod = P, data = D, model =
T)`` mesh) places a bundle's state by the reference's rule tables
(``dist.sharding.lm_param_specs`` / ``recsys_param_specs``, fitted to the
mesh by ``fit_specs``, the reference's ``_fit_specs``): every rank holds
exactly the shard of each parameter, and of its two AdamW moments, that
its fitted spec gives it (``dist.sharding.place``), and the models compute
on those shards as ``models.transformer`` and ``models.recsys`` say:
tensor-, expert- and vocab-parallel over ``model``, FSDP over ``data`` (the
LM train kinds whenever D > 1, as the reference's; the prefill and decode
drop FSDP where the parameters fit ``SERVE_FSDP_BYTES`` a rank on the model
axis alone, ``param_count * 2 / T``).  The batch is split over the batch
axes pod x data, pod-major (``shard_batch``: the reference's ``P(dp,
None)``; an LM train or prefill batch they cannot split raises, a recsys
or decode batch is then replicated, as ``_fit_specs`` leaves it) and
replicated over ``model``.  A train step takes the local mean loss's
gradients (FSDP leaves already summed over ``data`` by their gathers'
reduce-scatter), their mean over the batch ranks
(``dist.sharding.all_reduce_grads``: the FSDP leaves over ``pod`` alone),
then AdamW, whose clip reads the global norm over every axis that splits a
leaf (never ``pod``, whose ranks hold replicas); the loss returned is the
mean over the batch ranks, and an MoE layer's groups and loads are the
global batch's (``models.moe``), so the router bias moves as on one rank.
One step on a ``(P, D, T)`` mesh equals the one-rank step on the same
global batch up to float reassociation, and the state gathered whole
(``launch.train.state_tree``) is the same whichever layout produced it.

The serving kinds on a mesh return the global batch's outputs on every
rank (the reference's outputs are replicated): the prefill's and decode's
next tokens, DeepFM's scores (its ids split over the batch axes where they
divide them, the tables' vocab rows over ``model``), and retrieval's top k
(the candidates split over the batch axes where they divide them, the
query ids replicated: each rank's local top k, gathered, merged by a
stable descending sort, ties to the lower global id, as ``top_k``).  The
decode state's cache is placed by the reference's ``cache_spec``
(``models.transformer.cache_spec``: split-KV over ``model``).

A GNN train step on a mesh runs on its flattened axis (``HostMesh.flat``:
all R = P*D*T ranks in rank order, the reference's ``dp + ("model",)``):
the parameters replicated (``gnn_param_specs``), the graph batch's edge,
triplet and node arrays split into R contiguous blocks (``shard_batch``;
their ids global), each rank's message passing on its own edges and node
block (``models.gnn.GraphShard``).  A node-classification loss is the
global masked mean (each rank's share: its numerator over the global
count); a regression's per-graph readout sums the ranks' partials before
the replicated MSE.  Every gradient on a rank is then a partial sum: they
are summed, not averaged, over the flattened axis (``all_reduce_grads(...,
average=False)``), and the step returns the global loss on every rank.  A
graph whose nodes, edges or triplets R does not divide raises.  A one-rank
mesh is ``mesh=None``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
import os
from typing import Callable

import torch

from repro_torch.configs import ARCHS, ArchSpec
from repro_torch.configs.base import GraphShape, LMShape, RecsysShape
from repro_torch.configs.registry import reduced_config
from repro_torch.data.synthetic import InputSpec, shard_batch
from repro_torch.dist.sharding import (
    FSDP,
    all_reduce_grads,
    dp_size,
    gnn_param_specs,
    lm_param_specs,
    mesh_sizes,
    place,
    placement_of,
    recsys_param_specs,
)
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.models.common import model_device, top_k
from repro_torch.models.gnn import MACE, PNA, DimeNet, GraphShard, MeshGraphNet
from repro_torch.models.moe import update_router_bias
from repro_torch.models.recsys import DeepFM, deepfm_logits, deepfm_loss, retrieval_scores
from repro_torch.models.transformer import (
    Transformer,
    _logits,
    cache_spec,
    gather_logits,
    init_lm_cache,
    lm_decode_step,
    lm_hidden,
    lm_loss_and_stats,
)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

N_CLASSES = 64  # synthetic node-classification width
#: the serving kinds drop FSDP where the parameters' bfloat16 bytes over the
#: model axis alone fit this many a rank (the reference's value)
SERVE_FSDP_BYTES = 4 * 2**30


@dataclasses.dataclass
class StepBundle:
    name: str
    step_fn: Callable  # (state, batch) -> outputs, or (state', outputs) for decode
    abstract_inputs: dict  # name -> InputSpec
    init_state_fn: Callable[[int], dict]  # seed -> state on the bundle's device
    input_bounds: dict = dataclasses.field(default_factory=dict)  # int draws
    #: the step's kind and sizes, as ``launch.dryrun`` reckons them: "kind",
    #: "batch" (global rows), and "seq", "cache_spec", "candidates", "k"
    info: dict = dataclasses.field(default_factory=dict)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _pad(n: int, m: int = 512) -> int:
    return (n + m - 1) // m * m


def _train_step(loss_of: Callable, opt_cfg: AdamWConfig, after: Callable | None = None, *,
                mesh=None, shard: Callable = shard_batch, flat: bool = False):
    """``(state, batch) -> (state, {"loss", "gnorm"})``: ``loss_of(model,
    batch) -> (loss, aux)`` differentiated by autograd, one AdamW update in
    place, then ``after(model, aux)`` (outside the gradient path).  On a
    ``mesh`` (of D > 1 data ranks: ``build_bundle`` passes None for one):
    ``shard(batch, mesh)`` first, the gradients averaged over the data
    ranks before the update, and the loss returned their mean (over the
    batch axes, pod x data).  ``flat`` (a GNN step on a mesh): the loss is
    the rank's share of the global loss, which ``aux`` holds; the gradients
    are summed over the flattened axis and ``aux`` is returned."""
    dp = mesh is not None

    def step(state, batch):
        model = state["params"]
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        if dp:
            batch = shard(batch, mesh)
        with torch.enable_grad():
            loss, aux = loss_of(model, batch)
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        grads = {n: g for (n, _), g in zip(named, grads)}
        loss = loss.detach()
        if dp and flat:  # every rank's gradients are partial sums
            grads = all_reduce_grads(grads, dict(named), mesh.flat, average=False)
            loss = aux
        elif dp:
            # the sum comes before the update: AdamW clips by the global norm
            placed = placement_of(model)
            grads = all_reduce_grads(grads, dict(named), mesh.batch,
                                     summed=placed.data_split() if placed else frozenset(),
                                     pod=mesh.pod)
            loss = mesh.batch.all_reduce(loss, op="sum") / dp_size(mesh)
        gnorm = adamw_update(model, grads, state["opt"], opt_cfg)
        if after is not None:
            with torch.no_grad():
                after(model, aux)
        return state, {"loss": loss, "gnorm": gnorm}

    return step


def _placed(model: torch.nn.Module, specs_of: Callable, mesh, *, fsdp: bool = True):
    """``model`` sharded on ``mesh`` by its rule table ``specs_of``
    (``fsdp=False`` drops the data axis from every spec); unchanged off a
    mesh."""
    if mesh is None:
        return model
    specs = specs_of(model)
    if not fsdp:
        specs = {n: tuple(None if ax == FSDP else ax for ax in s) for n, s in specs.items()}
    return place(model, specs, mesh)


def _train_init(make_model: Callable[[int], torch.nn.Module], opt_cfg: AdamWConfig):
    def init_state(seed: int) -> dict:
        model = make_model(seed)
        return {"params": model, "opt": adamw_init(model, opt_cfg)}

    return init_state


# ---------------------------------------------------------------------------
# LM bundles
# ---------------------------------------------------------------------------


def _lm_bundle(spec: ArchSpec, shape: LMShape, *, reduced: bool, config,
               device, mesh) -> StepBundle:
    cfg = config or (reduced_config(spec) if reduced else spec.config)
    if reduced:
        shape = LMShape(shape.name, seq_len=32, global_batch=4, kind=shape.kind)
    name = f"{spec.arch_id}:{shape.name}"

    fsdp = shape.kind == "train" or serving_fsdp(cfg, mesh)

    def init_params(seed: int) -> Transformer:
        model = Transformer(cfg, generator=_generator(device, seed), device=device)
        return _placed(model, lm_param_specs, mesh, fsdp=fsdp)

    if shape.kind == "train":
        # bfloat16 moments halve the optimizer's bytes (the reference's knob)
        moment_dtype = (torch.bfloat16 if os.environ.get("REPRO_BF16_MOMENTS")
                        else torch.float32)
        opt_cfg = AdamWConfig(moment_dtype=moment_dtype)

        def loss_of(model, batch):
            loss, stats = lm_loss_and_stats(model, batch["tokens"], mesh=mesh)
            return loss, stats["moe_loads"]

        def move_router_bias(model, loads):
            # DeepSeek-V3 aux-free balancing: each layer's bias moves against
            # its observed expert load (the global batch's on a mesh),
            # outside the gradient path
            if cfg.moe and cfg.moe.aux_free_bias and loads is not None:
                for layer, load in zip(model.moe_layers, loads):
                    layer.moe.router_bias.copy_(update_router_bias(layer.moe.router_bias, load))

        return StepBundle(
            name=name, step_fn=_train_step(loss_of, opt_cfg, move_router_bias, mesh=mesh),
            abstract_inputs={"tokens": InputSpec((shape.global_batch, shape.seq_len + 1),
                                                 torch.int32)},
            init_state_fn=_train_init(init_params, opt_cfg),
            input_bounds={"tokens": cfg.vocab},
            info={"kind": "train", "batch": shape.global_batch, "seq": shape.seq_len},
        )

    if shape.kind == "prefill":
        @torch.inference_mode()
        def prefill(state, batch):
            model = state["params"]
            tokens = batch["tokens"] if mesh is None else shard_batch(batch, mesh)["tokens"]
            h, _, _ = lm_hidden(model, tokens, mesh=mesh)
            # one next token: project only the last position (on a model
            # axis, the vocab blocks gathered for the argmax)
            logits = gather_logits(model, _logits(model, h[:, -1:], mesh), mesh)
            nxt = logits[:, -1].argmax(dim=-1)
            if mesh is not None:  # every batch rank's rows, in rank order
                nxt = mesh.batch.all_gather(nxt).reshape(-1)
            return {"next_token": nxt}

        return StepBundle(
            name=name, step_fn=prefill,
            abstract_inputs={"tokens": InputSpec((shape.global_batch, shape.seq_len),
                                                 torch.int32)},
            init_state_fn=lambda seed: {"params": init_params(seed)},
            input_bounds={"tokens": cfg.vocab},
            info={"kind": "prefill", "batch": shape.global_batch, "seq": shape.seq_len},
        )

    # decode: one token against a seq_len KV cache
    b = 2 if reduced else shape.global_batch
    cache_len = 64 if reduced else shape.seq_len
    c_spec = None if mesh is None else cache_spec(cfg, b, cache_len, mesh)

    @torch.inference_mode()
    def decode(state, batch):
        tokens = batch["tokens"]
        if mesh is not None:  # the cache's batch split (cache_spec) is the same rule
            tokens = shard_batch({"tokens": tokens}, mesh, replicate_uneven=True)["tokens"]
        split = tokens.shape[0] != batch["tokens"].shape[0]
        logits, cache = lm_decode_step(state["params"], state["cache"], tokens, batch["pos"],
                                       mesh=mesh, cache_spec=c_spec)
        state = {"params": state["params"], "cache": cache}
        nxt = logits[:, -1].argmax(dim=-1)
        if split:  # every batch rank's rows, in rank order
            nxt = mesh.batch.all_gather(nxt).reshape(-1)
        return state, {"next_token": nxt}

    return StepBundle(
        name=name, step_fn=decode,
        abstract_inputs={"tokens": InputSpec((b, 1), torch.int32),
                         "pos": InputSpec((), torch.int32)},
        init_state_fn=lambda seed: {"params": init_params(seed),
                                    "cache": init_lm_cache(cfg, b, cache_len, device=device,
                                                           mesh=mesh)},
        input_bounds={"tokens": cfg.vocab},
        info={"kind": "decode", "batch": b, "seq": cache_len, "cache_spec": c_spec},
    )


def serving_fsdp(cfg, mesh) -> bool:
    """Whether a serving bundle keeps FSDP: where the parameters' bfloat16
    bytes over the model axis alone pass ``SERVE_FSDP_BYTES`` a rank (read
    at call time), as the reference's ``per_dev <= 4 * 2**30`` rule."""
    tp = 1 if mesh is None else mesh_sizes(mesh).get("model", 1)
    return cfg.param_count() * 2 / tp > SERVE_FSDP_BYTES


# ---------------------------------------------------------------------------
# GNN bundles
# ---------------------------------------------------------------------------


def _gnn_sizes(shape: GraphShape, *, reduced: bool) -> dict:
    if reduced:
        return dict(n=512, e=2048, d_feat=16, n_graphs=4, n_trip=1024, seeds=32)
    if shape.kind == "minibatch":
        seeds = shape.batch_nodes
        f1, f2 = shape.fanout
        n = _pad(seeds + seeds * f1 + seeds * f1 * f2)
        e = _pad(seeds * f1 + seeds * f1 * f2)
        return dict(n=n, e=e, d_feat=shape.d_feat, n_graphs=1, n_trip=_pad(e * 8), seeds=seeds)
    if shape.kind == "batched_small":
        g = shape.batch_graphs
        n = _pad(g * shape.n_nodes)
        e = _pad(g * shape.n_edges)
        return dict(n=n, e=e, d_feat=max(shape.d_feat, 16), n_graphs=g, n_trip=_pad(g * 256))
    n = _pad(shape.n_nodes)
    e = _pad(shape.n_edges)
    n_trip = min(_pad(2 * e), 1 << 27)
    return dict(n=n, e=e, d_feat=shape.d_feat, n_graphs=1, n_trip=n_trip)


def gnn_regression(cfg, shape: GraphShape) -> bool:
    """Whether a GNN cell regresses per-graph targets (batched small graphs
    and the geometric models) rather than classifying nodes."""
    return shape.kind == "batched_small" or cfg.kind in ("mace", "dimenet")


def gnn_model(cfg, sz: dict, regression: bool, *, generator=None, device="cuda"):
    """A GNN bundle's model for ``cfg`` at the sizes ``sz``
    (``_gnn_sizes``): node outputs of 1 (a regression) or ``N_CLASSES``
    wide."""
    d_out = 1 if regression else N_CLASSES
    if cfg.kind == "pna":
        return PNA(cfg, sz["d_feat"], d_out, generator=generator, device=device)
    if cfg.kind == "meshgraphnet":
        return MeshGraphNet(cfg, sz["d_feat"], 4, d_out, generator=generator, device=device)
    if cfg.kind == "mace":
        return MACE(cfg, generator=generator, device=device)
    return DimeNet(cfg, 1, generator=generator, device=device)


def _masked_nll(ll: torch.Tensor, w: torch.Tensor, axis) -> tuple:
    """``-(ll * w).sum() / max(w.sum(), 1)`` as ``(this rank's share, the
    global loss)``: on the flattened ``axis`` the share is the rank's
    numerator over the count summed over the ranks (one all-reduce of the
    pair), so the shares' gradients sum to the global loss's."""
    num = -(ll * w).sum()
    den = w.sum()
    if axis is None or axis.world_size == 1:
        loss = num / torch.clamp(den, min=1.0)
        return loss, loss.detach()
    both = axis.all_reduce(torch.stack([num.detach(), den]), op="sum")
    den = torch.clamp(both[1], min=1.0)
    return num / den, both[0] / den


def _gnn_bundle(spec: ArchSpec, shape: GraphShape, *, reduced: bool, config,
                device, mesh) -> StepBundle:
    cfg = config or (reduced_config(spec) if reduced else spec.config)
    sz = _gnn_sizes(shape, reduced=reduced)
    kind = cfg.kind
    opt_cfg = AdamWConfig(weight_decay=0.0)
    geometric = kind in ("mace", "dimenet")
    regression = gnn_regression(cfg, shape)
    n, e = sz["n"], sz["e"]
    axis = None if mesh is None else mesh.flat
    if axis is not None:
        counts = {"nodes": n, "edges": e, **({"triplets": sz["n_trip"]} if kind == "dimenet"
                                             else {})}
        for what, count in counts.items():
            if count % axis.world_size:
                raise ValueError(f"{spec.arch_id}:{shape.name}: {count} {what} cannot be split "
                                 f"over the {axis.world_size} ranks of the flattened axis")
    shard = None if axis is None else GraphShard(axis, n)

    inputs = {
        "edge_src": InputSpec((e,), torch.int32),
        "edge_dst": InputSpec((e,), torch.int32),
        "edge_mask": InputSpec((e,), torch.bool),
    }
    if geometric:
        inputs["species"] = InputSpec((n,), torch.int32)
        inputs["positions"] = InputSpec((n, 3), torch.float32)
    else:
        inputs["x"] = InputSpec((n, sz["d_feat"]), torch.float32)
    if kind == "meshgraphnet":
        inputs["edge_feat"] = InputSpec((e, 4), torch.float32)
    if kind == "dimenet":
        for k in ("trip_kj", "trip_ji"):
            inputs[k] = InputSpec((sz["n_trip"],), torch.int32)
        inputs["trip_mask"] = InputSpec((sz["n_trip"],), torch.bool)
    if regression:
        inputs["graph_id"] = InputSpec((n,), torch.int32)
        inputs["labels"] = InputSpec((sz["n_graphs"],), torch.float32)
    else:
        inputs["labels"] = InputSpec((n,), torch.int32)
        inputs["label_mask"] = InputSpec((n,), torch.bool)

    def init_model(seed: int) -> torch.nn.Module:
        model = gnn_model(cfg, sz, regression, generator=_generator(device, seed), device=device)
        return _placed(model, gnn_param_specs, mesh)

    def forward(model, batch):
        edges = (batch["edge_src"], batch["edge_dst"])
        kw = dict(edge_mask=batch["edge_mask"], shard=shard)
        if kind == "pna":
            return model(batch["x"], *edges, **kw)
        if kind == "meshgraphnet":
            return model(batch["x"], batch["edge_feat"], *edges, **kw)
        if kind == "mace":
            return model(batch["species"], batch["positions"], *edges,
                         graph_id=batch["graph_id"], n_graphs=sz["n_graphs"], **kw)
        return model(batch["species"], batch["positions"], *edges, batch["trip_kj"],
                     batch["trip_ji"], trip_mask=batch["trip_mask"],
                     graph_id=batch["graph_id"], n_graphs=sz["n_graphs"], **kw)[:, 0]

    def loss_of(model, batch):
        """``(this rank's share of the loss, the global loss)``."""
        out = forward(model, batch)
        if regression:
            if kind in ("pna", "meshgraphnet"):
                # node outputs -> per-graph readout, summed by the kernel
                out = segment_sum(batch["graph_id"], out[:, 0], sz["n_graphs"])
                if shard is not None:  # the ranks' partial sums, summed
                    out = shard.total(out)
            loss = torch.mean((out - batch["labels"]) ** 2)  # replicated
            return loss, loss.detach()
        logp = torch.log_softmax(out.to(torch.float32), dim=-1)
        ll = torch.take_along_dim(logp, batch["labels"][:, None].long(), dim=1)[:, 0]
        return _masked_nll(ll, batch["label_mask"].to(torch.float32), axis)

    return StepBundle(
        name=f"{spec.arch_id}:{shape.name}",
        step_fn=_train_step(loss_of, opt_cfg, mesh=mesh, flat=True),
        abstract_inputs=inputs,
        init_state_fn=_train_init(init_model, opt_cfg),
        input_bounds={
            "labels": 1 if regression else N_CLASSES, "species": 10,
            "graph_id": sz["n_graphs"], "edge_src": n, "edge_dst": n,
            "trip_kj": e, "trip_ji": e,
        },
        info={"kind": "train", "graph": dict(sz), "regression": regression},
    )


# ---------------------------------------------------------------------------
# RecSys bundles
# ---------------------------------------------------------------------------


def _global_rows(out: torch.Tensor, n_rows: int, mesh) -> torch.Tensor:
    """A serving output of the rank's rows -> the global batch's, on every
    rank (gathered over the batch ranks where they split the batch)."""
    if mesh is None or out.shape[0] == n_rows:
        return out
    every = mesh.batch.all_gather(out)
    return every.reshape(-1, *out.shape[1:])


def retrieval_top_k(scores: torch.Tensor, k: int, mesh=None, offset: int = 0):
    """The top ``k`` of ``[B, N]`` scores, ties to the lower index
    (``top_k``); on ``mesh`` the scores are the rank's candidates, global ids
    ``offset + j``: each rank's top k (global ids), all-gathered over the
    batch ranks and merged by a stable descending sort over the ranks'
    lists in rank order, which keeps ties in ascending global id."""
    vals, idx = top_k(scores, min(k, scores.shape[-1]))
    if mesh is None or mesh.batch.world_size == 1:
        return vals, idx
    idx = idx + offset
    every_v = mesh.batch.all_gather(vals)  # [D, B, k]
    every_i = mesh.batch.all_gather(idx)
    v = torch.cat(list(every_v.unbind(0)), dim=-1)
    i = torch.cat(list(every_i.unbind(0)), dim=-1)
    order = torch.sort(v, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.take_along_dim(v, order, dim=-1), torch.take_along_dim(i, order, dim=-1)


def _recsys_bundle(spec: ArchSpec, shape: RecsysShape, *, reduced: bool, config,
                   device, mesh) -> StepBundle:
    cfg = config or (reduced_config(spec) if reduced else spec.config)
    b = 8 if reduced else shape.batch
    name = f"{spec.arch_id}:{shape.name}"

    def init_model(seed: int) -> DeepFM:
        model = DeepFM(cfg, generator=_generator(device, seed), device=device)
        return _placed(model, recsys_param_specs, mesh)

    def init_state(seed: int) -> dict:
        return {"params": init_model(seed)}

    if shape.kind == "train":
        opt_cfg = AdamWConfig(weight_decay=0.0)

        def loss_of(model, batch):
            return deepfm_loss(model, batch["ids"], batch["labels"], mesh), None

        return StepBundle(
            name=name, step_fn=_train_step(loss_of, opt_cfg, mesh=mesh,
                                           shard=partial(shard_batch, replicate_uneven=True)),
            abstract_inputs={
                "ids": InputSpec((b, cfg.n_sparse, cfg.multi_hot), torch.int32),
                "labels": InputSpec((b,), torch.float32),
            },
            init_state_fn=_train_init(init_model, opt_cfg),
            input_bounds={"ids": cfg.vocab_per_field},
            info={"kind": "train", "batch": b},
        )

    if shape.kind == "retrieval":
        n_cand = 4096 if reduced else shape.n_candidates
        k = 8 if reduced else 100

        @torch.inference_mode()
        def retrieval(state, batch):
            cands = batch["candidates"]
            if mesh is not None:  # P(dp, None) where the ranks divide them
                cands = shard_batch({"c": cands}, mesh, replicate_uneven=True)["c"]
            split = cands.shape[0] != batch["candidates"].shape[0]
            scores = retrieval_scores(state["params"], batch["ids"], cands, mesh)
            top_scores, top_ids = retrieval_top_k(
                scores, k, mesh if split else None,
                mesh.batch.rank * cands.shape[0] if split else 0)
            return {"top_scores": top_scores, "top_ids": top_ids}

        return StepBundle(
            name=name, step_fn=retrieval,
            abstract_inputs={
                "ids": InputSpec((b, cfg.n_sparse, cfg.multi_hot), torch.int32),
                "candidates": InputSpec((n_cand, cfg.embed_dim), torch.float32),
            },
            init_state_fn=init_state,
            input_bounds={"ids": cfg.vocab_per_field},
            info={"kind": "retrieval", "batch": b, "candidates": n_cand, "k": k},
        )

    @torch.inference_mode()
    def serve(state, batch):
        ids = batch["ids"] if mesh is None else shard_batch(batch, mesh,
                                                            replicate_uneven=True)["ids"]
        scores = torch.sigmoid(deepfm_logits(state["params"], ids, mesh))
        return {"scores": _global_rows(scores, batch["ids"].shape[0], mesh)}

    return StepBundle(
        name=name, step_fn=serve,
        abstract_inputs={"ids": InputSpec((b, cfg.n_sparse, cfg.multi_hot), torch.int32)},
        init_state_fn=init_state,
        input_bounds={"ids": cfg.vocab_per_field},
        info={"kind": "serve", "batch": b},
    )


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def build_bundle(arch_id: str, shape_name: str, *, reduced: bool = False, config=None,
                 device=None, mesh=None) -> StepBundle:
    """The bundle for ``arch_id`` at ``shape_name``: the published config, or
    ``reduced_config`` under ``reduced``, or ``config`` where the caller
    passes one (e.g. the published widths at a cut depth).  An LM's
    parameters are bfloat16, as the reference's; its prefill runs GQA on
    the flash kernel on a card (``models.attention``), on a mesh each
    model rank on its own heads; its train step the plain attention paths.
    ``device``: the mesh's where there is one, else the card unless the
    caller asks for the CPU.  ``mesh``: see the module docstring."""
    spec = ARCHS[arch_id]
    shape = spec.shapes()[shape_name]
    if mesh is not None:
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device!r} is not the mesh's {mesh.device}")
        device = mesh.device
        if mesh.size == 1:
            mesh = None  # one rank: the one-device step, bit for bit
    device = model_device("cuda" if device is None else device)
    kw = dict(reduced=reduced, config=config, device=device)
    if spec.family == "lm":
        return _lm_bundle(spec, shape, mesh=mesh, **kw)
    if spec.family == "gnn":
        return _gnn_bundle(spec, shape, mesh=mesh, **kw)
    return _recsys_bundle(spec, shape, mesh=mesh, **kw)
