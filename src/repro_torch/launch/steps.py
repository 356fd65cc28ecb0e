"""Step bundles, serving kinds (``repro.launch.steps`` counterpart): per
(architecture x input shape), the step function, its inputs' shapes and
bounds, and a seeded state.

  * LM ``prefill``: the forward pass over the prompt, the next token from
    the last position only (no ``[B, S, V]`` logits); ``decode``: one token
    against a ``seq_len`` cache (``reduced``: 2 sequences, 64 slots).
  * recsys ``serve``: sigmoid scores; ``retrieval``: the top 100 (8
    reduced) of the candidates' scores.

Every step runs under ``torch.inference_mode()`` on the bundle's device
(the card unless the caller asks for the CPU).  There are no
``PartitionSpec``s: one device holds the model.  The train kinds and the
GNN bundle are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import ARCHS, ArchSpec
from repro_torch.configs.base import LMShape, RecsysShape
from repro_torch.configs.registry import reduced_config
from repro_torch.data.synthetic import InputSpec
from repro_torch.models.common import model_device, top_k
from repro_torch.models.recsys import DeepFM, deepfm_logits, retrieval_scores
from repro_torch.models.transformer import (
    Transformer,
    _logits,
    init_lm_cache,
    lm_decode_step,
    lm_hidden,
)


@dataclasses.dataclass
class StepBundle:
    name: str
    step_fn: Callable  # (state, batch) -> outputs, or (state', outputs) for decode
    abstract_inputs: dict  # name -> InputSpec
    init_state_fn: Callable[[int], dict]  # seed -> state on the bundle's device
    input_bounds: dict = dataclasses.field(default_factory=dict)  # int draws


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# LM bundles
# ---------------------------------------------------------------------------


def _lm_bundle(spec: ArchSpec, shape: LMShape, *, reduced: bool, config,
               device) -> StepBundle:
    cfg = config or (reduced_config(spec) if reduced else spec.config)
    if reduced:
        shape = LMShape(shape.name, seq_len=32, global_batch=4, kind=shape.kind)
    if shape.kind == "train":
        raise NotImplementedError(f"{spec.arch_id}:{shape.name}: the train step is not ported")
    name = f"{spec.arch_id}:{shape.name}"

    def init_params(seed: int) -> Transformer:
        return Transformer(cfg, generator=_generator(device, seed), device=device)

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
# RecSys bundles
# ---------------------------------------------------------------------------


def _recsys_bundle(spec: ArchSpec, shape: RecsysShape, *, reduced: bool, config,
                   device) -> StepBundle:
    cfg = config or (reduced_config(spec) if reduced else spec.config)
    if shape.kind == "train":
        raise NotImplementedError(f"{spec.arch_id}:{shape.name}: the train step is not ported")
    b = 8 if reduced else shape.batch
    name = f"{spec.arch_id}:{shape.name}"

    def init_state(seed: int) -> dict:
        return {"params": DeepFM(cfg, generator=_generator(device, seed), device=device)}

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
    passes one (e.g. the published widths at a cut depth).  An LM's state is
    bfloat16, as the reference's; its prefill runs GQA on the flash kernel
    on a card (``models.attention``)."""
    spec = ARCHS[arch_id]
    shape = spec.shapes()[shape_name]
    device = model_device(device)
    if spec.family == "lm":
        return _lm_bundle(spec, shape, reduced=reduced, config=config, device=device)
    if spec.family == "recsys":
        return _recsys_bundle(spec, shape, reduced=reduced, config=config, device=device)
    raise NotImplementedError(f"{arch_id}: the GNN bundle is not ported")
