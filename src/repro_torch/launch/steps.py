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
for; the serving steps under ``torch.inference_mode()``.  There are no
``PartitionSpec``s: one device holds the model.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from repro_torch.configs import ARCHS, ArchSpec
from repro_torch.configs.base import GraphShape, LMShape, RecsysShape
from repro_torch.configs.registry import reduced_config
from repro_torch.data.synthetic import InputSpec
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.models.common import model_device, top_k
from repro_torch.models.gnn import MACE, PNA, DimeNet, MeshGraphNet
from repro_torch.models.moe import update_router_bias
from repro_torch.models.recsys import DeepFM, deepfm_logits, deepfm_loss, retrieval_scores
from repro_torch.models.transformer import (
    Transformer,
    _logits,
    init_lm_cache,
    lm_decode_step,
    lm_hidden,
    lm_loss_and_stats,
)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

N_CLASSES = 64  # synthetic node-classification width


@dataclasses.dataclass
class StepBundle:
    name: str
    step_fn: Callable  # (state, batch) -> outputs, or (state', outputs) for decode
    abstract_inputs: dict  # name -> InputSpec
    init_state_fn: Callable[[int], dict]  # seed -> state on the bundle's device
    input_bounds: dict = dataclasses.field(default_factory=dict)  # int draws


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _pad(n: int, m: int = 512) -> int:
    return (n + m - 1) // m * m


def _train_step(loss_of: Callable, opt_cfg: AdamWConfig, after: Callable | None = None):
    """``(state, batch) -> (state, {"loss", "gnorm"})``: ``loss_of(model,
    batch) -> (loss, aux)`` differentiated by autograd, one AdamW update in
    place, then ``after(model, aux)`` (outside the gradient path)."""

    def step(state, batch):
        model = state["params"]
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        with torch.enable_grad():
            loss, aux = loss_of(model, batch)
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        gnorm = adamw_update(model, {n: g for (n, _), g in zip(named, grads)},
                             state["opt"], opt_cfg)
        if after is not None:
            with torch.no_grad():
                after(model, aux)
        return state, {"loss": loss.detach(), "gnorm": gnorm}

    return step


def _train_init(make_model: Callable[[int], torch.nn.Module], opt_cfg: AdamWConfig):
    def init_state(seed: int) -> dict:
        model = make_model(seed)
        return {"params": model, "opt": adamw_init(model, opt_cfg)}

    return init_state


# ---------------------------------------------------------------------------
# LM bundles
# ---------------------------------------------------------------------------


def _lm_bundle(spec: ArchSpec, shape: LMShape, *, reduced: bool, config,
               device) -> StepBundle:
    cfg = config or (reduced_config(spec) if reduced else spec.config)
    if reduced:
        shape = LMShape(shape.name, seq_len=32, global_batch=4, kind=shape.kind)
    name = f"{spec.arch_id}:{shape.name}"

    def init_params(seed: int) -> Transformer:
        return Transformer(cfg, generator=_generator(device, seed), device=device)

    if shape.kind == "train":
        # bfloat16 moments halve the optimizer's bytes (the reference's knob)
        moment_dtype = (torch.bfloat16 if os.environ.get("REPRO_BF16_MOMENTS")
                        else torch.float32)
        opt_cfg = AdamWConfig(moment_dtype=moment_dtype)

        def loss_of(model, batch):
            loss, stats = lm_loss_and_stats(model, batch["tokens"])
            return loss, stats["moe_loads"]

        def move_router_bias(model, loads):
            # DeepSeek-V3 aux-free balancing: each layer's bias moves against
            # its observed expert load, outside the gradient path
            if cfg.moe and cfg.moe.aux_free_bias and loads is not None:
                for layer, load in zip(model.moe_layers, loads):
                    layer.moe.router_bias.copy_(update_router_bias(layer.moe.router_bias, load))

        return StepBundle(
            name=name, step_fn=_train_step(loss_of, opt_cfg, move_router_bias),
            abstract_inputs={"tokens": InputSpec((shape.global_batch, shape.seq_len + 1),
                                                 torch.int32)},
            init_state_fn=_train_init(init_params, opt_cfg),
            input_bounds={"tokens": cfg.vocab},
        )

    if shape.kind == "prefill":
        @torch.inference_mode()
        def prefill(state, batch):
            model = state["params"]
            h, _, _ = lm_hidden(model, batch["tokens"])
            # one next token: project only the last position
            logits = _logits(model, h[:, -1:])
            return {"next_token": logits[:, -1].argmax(dim=-1)}

        return StepBundle(
            name=name, step_fn=prefill,
            abstract_inputs={"tokens": InputSpec((shape.global_batch, shape.seq_len),
                                                 torch.int32)},
            init_state_fn=lambda seed: {"params": init_params(seed)},
            input_bounds={"tokens": cfg.vocab},
        )

    # decode: one token against a seq_len KV cache
    b = 2 if reduced else shape.global_batch
    cache_len = 64 if reduced else shape.seq_len

    @torch.inference_mode()
    def decode(state, batch):
        logits, cache = lm_decode_step(state["params"], state["cache"], batch["tokens"],
                                       batch["pos"])
        state = {"params": state["params"], "cache": cache}
        return state, {"next_token": logits[:, -1].argmax(dim=-1)}

    return StepBundle(
        name=name, step_fn=decode,
        abstract_inputs={"tokens": InputSpec((b, 1), torch.int32),
                         "pos": InputSpec((), torch.int32)},
        init_state_fn=lambda seed: {"params": init_params(seed),
                                    "cache": init_lm_cache(cfg, b, cache_len, device=device)},
        input_bounds={"tokens": cfg.vocab},
    )


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


def _gnn_bundle(spec: ArchSpec, shape: GraphShape, *, reduced: bool, config,
                device) -> StepBundle:
    cfg = config or (reduced_config(spec) if reduced else spec.config)
    sz = _gnn_sizes(shape, reduced=reduced)
    kind = cfg.kind
    opt_cfg = AdamWConfig(weight_decay=0.0)
    geometric = kind in ("mace", "dimenet")
    regression = shape.kind == "batched_small" or geometric
    n, e = sz["n"], sz["e"]

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
        g = _generator(device, seed)
        d_out = 1 if regression else N_CLASSES
        if kind == "pna":
            return PNA(cfg, sz["d_feat"], d_out, generator=g, device=device)
        if kind == "meshgraphnet":
            return MeshGraphNet(cfg, sz["d_feat"], 4, d_out, generator=g, device=device)
        if kind == "mace":
            return MACE(cfg, generator=g, device=device)
        return DimeNet(cfg, 1, generator=g, device=device)

    def forward(model, batch):
        edges = (batch["edge_src"], batch["edge_dst"])
        mask = batch["edge_mask"]
        if kind == "pna":
            return model(batch["x"], *edges, edge_mask=mask)
        if kind == "meshgraphnet":
            return model(batch["x"], batch["edge_feat"], *edges, edge_mask=mask)
        if kind == "mace":
            return model(batch["species"], batch["positions"], *edges, edge_mask=mask,
                         graph_id=batch["graph_id"], n_graphs=sz["n_graphs"])
        return model(batch["species"], batch["positions"], *edges, batch["trip_kj"],
                     batch["trip_ji"], edge_mask=mask, trip_mask=batch["trip_mask"],
                     graph_id=batch["graph_id"], n_graphs=sz["n_graphs"])[:, 0]

    def loss_of(model, batch):
        out = forward(model, batch)
        if regression:
            if kind in ("pna", "meshgraphnet"):
                # node outputs -> per-graph readout, summed by the kernel
                per_graph = segment_sum(batch["graph_id"], out[:, 0], sz["n_graphs"])
                return torch.mean((per_graph - batch["labels"]) ** 2), None
            return torch.mean((out - batch["labels"]) ** 2), None
        logp = torch.log_softmax(out.to(torch.float32), dim=-1)
        ll = torch.take_along_dim(logp, batch["labels"][:, None].long(), dim=1)[:, 0]
        w = batch["label_mask"].to(torch.float32)
        return -(ll * w).sum() / torch.clamp(w.sum(), min=1.0), None

    return StepBundle(
        name=f"{spec.arch_id}:{shape.name}", step_fn=_train_step(loss_of, opt_cfg),
        abstract_inputs=inputs,
        init_state_fn=_train_init(init_model, opt_cfg),
        input_bounds={
            "labels": 1 if regression else N_CLASSES, "species": 10,
            "graph_id": sz["n_graphs"], "edge_src": n, "edge_dst": n,
            "trip_kj": e, "trip_ji": e,
        },
    )


# ---------------------------------------------------------------------------
# RecSys bundles
# ---------------------------------------------------------------------------


def _recsys_bundle(spec: ArchSpec, shape: RecsysShape, *, reduced: bool, config,
                   device) -> StepBundle:
    cfg = config or (reduced_config(spec) if reduced else spec.config)
    b = 8 if reduced else shape.batch
    name = f"{spec.arch_id}:{shape.name}"

    def init_model(seed: int) -> DeepFM:
        return DeepFM(cfg, generator=_generator(device, seed), device=device)

    def init_state(seed: int) -> dict:
        return {"params": init_model(seed)}

    if shape.kind == "train":
        opt_cfg = AdamWConfig(weight_decay=0.0)

        def loss_of(model, batch):
            return deepfm_loss(model, batch["ids"], batch["labels"]), None

        return StepBundle(
            name=name, step_fn=_train_step(loss_of, opt_cfg),
            abstract_inputs={
                "ids": InputSpec((b, cfg.n_sparse, cfg.multi_hot), torch.int32),
                "labels": InputSpec((b,), torch.float32),
            },
            init_state_fn=_train_init(init_model, opt_cfg),
            input_bounds={"ids": cfg.vocab_per_field},
        )

    if shape.kind == "retrieval":
        n_cand = 4096 if reduced else shape.n_candidates
        k = 8 if reduced else 100

        @torch.inference_mode()
        def retrieval(state, batch):
            scores = retrieval_scores(state["params"], batch["ids"], batch["candidates"])
            top_scores, top_ids = top_k(scores, k)
            return {"top_scores": top_scores, "top_ids": top_ids}

        return StepBundle(
            name=name, step_fn=retrieval,
            abstract_inputs={
                "ids": InputSpec((b, cfg.n_sparse, cfg.multi_hot), torch.int32),
                "candidates": InputSpec((n_cand, cfg.embed_dim), torch.float32),
            },
            init_state_fn=init_state,
            input_bounds={"ids": cfg.vocab_per_field},
        )

    @torch.inference_mode()
    def serve(state, batch):
        return {"scores": torch.sigmoid(deepfm_logits(state["params"], batch["ids"]))}

    return StepBundle(
        name=name, step_fn=serve,
        abstract_inputs={"ids": InputSpec((b, cfg.n_sparse, cfg.multi_hot), torch.int32)},
        init_state_fn=init_state,
        input_bounds={"ids": cfg.vocab_per_field},
    )


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def build_bundle(arch_id: str, shape_name: str, *, reduced: bool = False, config=None,
                 device="cuda") -> StepBundle:
    """The bundle for ``arch_id`` at ``shape_name``: the published config, or
    ``reduced_config`` under ``reduced``, or ``config`` where the caller
    passes one (e.g. the published widths at a cut depth).  An LM's
    parameters are bfloat16, as the reference's; its prefill runs GQA on
    the flash kernel on a card (``models.attention``), its train step the
    plain attention paths."""
    spec = ARCHS[arch_id]
    shape = spec.shapes()[shape_name]
    device = model_device(device)
    if spec.family == "lm":
        return _lm_bundle(spec, shape, reduced=reduced, config=config, device=device)
    if spec.family == "gnn":
        return _gnn_bundle(spec, shape, reduced=reduced, config=config, device=device)
    return _recsys_bundle(spec, shape, reduced=reduced, config=config, device=device)
