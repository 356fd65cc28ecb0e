"""The dry run's intent (``repro.launch.dryrun`` counterpart): for every
(architecture x input shape) cell and both production meshes, what a rank
holds and which collectives one step issues -- reckoned, and held to what
ranks actually issue.

The reference lowers and compiles each cell's step for the 256- and
512-chip meshes and reads memory, FLOPs and collectives off the compiled
HLO.  The port has no HLO: it runs eager PyTorch, one process per rank.
So the dry run here has two halves.

  * **Reckoning** (``reckon_cell``, the CLI): the cell's state is built on
    meta tensors (``with torch.device("meta")``: no allocation), its
    parameters' specs fitted to the production layout
    (``launch.mesh.make_production_mesh``: ``(data 16, model 16)`` or
    ``(pod 2, data 16, model 16)``), and from them
    ``state_bytes_per_rank`` (each parameter's, moment's and cache tensor's
    fitted shard) and ``derived_collectives`` (each collective of one step,
    per axis and op, with its bytes), priced by ``wire_bytes``, the
    reference's ring formula.  The record holds no temporaries and no
    FLOPs: nothing compiles the step ahead of time.
  * **Checking** (``run_cell_on_ranks``): the reduced bundle on a host mesh
    of gloo ranks runs one step on seeded inputs; each rank reads its
    ``HostMesh.stats()`` around it and returns the measured calls and bytes
    beside ``derived_collectives``' for the same mesh.  The tests hold them
    equal on every mesh shape they run, so each formula the reckoning
    evaluates at 256 or 512 ranks is one a run of the same axes checked.

A GNN cell is reckoned on the flattened axis its step runs on (``flat``:
all 256 or 512 ranks, the reference's ``dp + ("model",)``): its graph split
over them, its parameters replicated.  The shapes an architecture skips
keep the reference's reasons.

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepfm --shape serve_bulk
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single   # one mesh only

Results go to ``artifacts/dryrun/<arch>__<shape>__<mesh>.json``, one file a
cell, so a rerun resumes (``--force`` redoes them).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import GNNConfig, LMConfig
from repro_torch.dist import sharding
from repro_torch.dist.sharding import FSDP, MODEL, axis_size, fit_specs, mesh_sizes
from repro_torch.models import moe as moe_mod

ART_DIR = "artifacts/dryrun"
#: what the reckoning cannot see (the reference's compiled step gives them)
NOT_RECKONED = ("no temporaries and no FLOPs: nothing compiles the step ahead of time; "
                "state_bytes_per_rank counts parameters, moments and caches only")

_GQA = ("wq", "wk", "wv", "wo")
_MLA_HEADS = ("w_uq", "w_uk", "w_uv", "wo")
_MLA_REST = ("w_dq", "q_norm", "w_dkv", "kv_norm", "w_kr")
_MLP = ("w_gate", "w_up", "w_down")
_EXPERTS = ("we_gate", "we_up", "we_down")


def wire_bytes(op: str, nbytes: float, g: int) -> float:
    """The reference's ring wire bytes a device sends for one collective
    over ``g`` ranks (``dryrun.py:104-112``), from the bytes
    ``CollectiveStats`` records for it: an all-reduce's tensor (``2 size
    (g-1)/g``), an all-gather's per-rank block (its result is ``g`` of them:
    ``size (g-1)/g``), a reduce-scatter's whole input (its result, a ``g``-th
    of it, times ``g - 1``), an all-to-all's tensor (``size (g-1)/g``)."""
    if g <= 1:
        return 0.0
    ring = (g - 1) / g
    return {
        "all_reduce": 2 * nbytes * ring,
        "all_gather": nbytes * g * ring,
        "reduce_scatter": nbytes / g * (g - 1),
        "all_to_all": nbytes * ring,
        "all_to_all_v": nbytes * ring,
    }[op]


def _axis_sizes(mesh_sizes_: dict) -> dict:
    p = int(mesh_sizes_.get("pod", 1))
    d = int(mesh_sizes_.get("data", 1))
    t = int(mesh_sizes_.get("model", 1))
    return {"pod": p, "data": d, "model": t, "batch": p * d, "flat": p * d * t}


def derived_collectives(cfg, kind: str, specs: dict, shapes: dict, mesh_sizes_: dict, *,
                        batch: int | None = None, seq: int | None = None, elts=4,
                        act: int | None = None,
                        groups: int | None = None, cache_spec: tuple | None = None,
                        candidates: int | None = None, k: int | None = None,
                        frozen=frozenset(), graph: dict | None = None,
                        regression: bool = False) -> dict:
    """The collectives one step issues on each rank, per axis and op, with
    their bytes (as ``CollectiveStats`` records them), derived from the
    fitted ``specs`` (name -> axis tuple), the rank's parameter ``shapes``
    (name -> local shape), ``elts`` (their element bytes: one int, or name
    -> bytes) and the mesh's sizes (``pod``, ``data``, ``model``).

    The design it counts (``dist.sharding``, ``models.*``,
    ``launch.steps``): ``batch`` global rows split over the batch axes pod x
    data (``"batch"``; ``"data"`` where there is no pod axis) and
    replicated over ``model``; activations of ``act`` bytes (the
    embedding's).

      * A weight read (``sharding.weights``) walks its spec in order: each
        FSDP dim all-gathers over ``data`` (D > 1; twice under a remat
        replay), its gradient reduce-scattered once; each ``model`` dim of a
        layer on the replicated path (heads that ``model`` cannot split)
        all-gathers over ``model``.
      * Over ``model`` (T > 1), forward: the vocab-parallel lookup's sum;
        attention's ``wo`` sum (GQA and MLA; replayed under remat) and MLA's
        two latent gathers; the MLP's and shared experts' closing sum (not
        replayed); the experts' outputs gathered (replayed); the logits:
        train's cross entropy (max, sum of exponentials, target), the
        prefill's and decode's vocab blocks gathered.  Backward, each
        ``copy_to_model`` input's gradient summed: x into attention, the
        MLP, the experts, the shared experts, MLA's two latent projections,
        ``q_lat``, ``c`` and ``k_rope``, h into the logits, MTP's ``proj``.
      * Decode: each layer's new k and v (and q where the cache is split in
        time) gathered over ``model`` where its heads split, the split-KV
        partials ``(max, sum, output)`` gathered in float32, then ``wo``'s
        sum; MLA's ``q_abs``/``q_rope`` gathered where split in time; the
        next tokens (int64) gathered over the batch axes where they split
        the batch; no MoE loads.
      * Train, over the batch axes: the leaves ``data`` leaves whole in
        buckets of at most ``GRAD_BUCKET_BYTES`` a dtype, then the FSDP
        leaves' buckets over ``pod`` (P > 1), the loss, an MoE model's loads
        (float32 ``[L_moe, G/dp, E]``, also in the prefill); the global
        norm's float32 pair over ``data`` (where it splits a leaf) and
        ``model`` (where it splits one).
      * DeepFM: each bag (the tables', and serving's first-order terms')
        summed over ``model``; serve's scores gathered over the batch axes
        where its ids split; retrieval's local top ``k`` (float32 scores and
        int64 ids) gathered where the ``candidates`` split.
      * GNN (``graph``: the bundle's ``_gnn_sizes``), all over the flattened
        axis ``flat`` of R = P*D*T ranks, float32: each node table a layer
        reads gathered (all-gather of the ``N/R`` block; its gradient
        reduce-scattered, ``N`` rows), each partial aggregate
        reduce-scattered (``N`` rows; its gradient all-gathered), each
        max or min all-reduced (``N`` rows) with, backward, its gradient
        blocks all-gathered and its tie counts all-reduced.  PNA: the
        degrees once (no gradient), then per layer its messages gathered,
        mean and std two sums, max and min; MeshGraphNet: per layer ``h``
        gathered and the edge sums; MACE: the positions once (no gradient),
        per layer ``h [N/R, C, 9]`` gathered and the A-basis; DimeNet: the
        edge layout (int64 ``E/R``), the positions, the edge vectors
        (``E/R x 3``, no gradient) and the embedded ``h`` once, per block
        ``m @ down`` gathered over the edge layout (``E/R x nb``) and its
        triplet sums reduce-scattered (``E`` rows), and the edge-to-node
        sums.  A regression's readout all-reduced (``n_graphs``), a
        classification's masked-mean pair (8 bytes); the gradients summed
        in buckets; no norm collective (every leaf whole).

    ``groups``: an MoE layer's dispatch groups over the global batch
    (``moe._n_groups`` of its tokens by default); ``frozen``: the
    parameters no gradient reaches (``router_bias``).  Returns ``{"calls":
    {axis: {op: n}}, "bytes": {axis: {op: bytes}}}`` with axes ``data`` and
    ``model``, ``flat``, and ``pod`` and ``batch`` where P > 1.
    """
    n = _axis_sizes(mesh_sizes_)
    p_, d_, t_, dp = n["pod"], n["data"], n["model"], n["batch"]
    axes = ("data", "model", "flat") + (("pod", "batch") if p_ > 1 else ())
    calls = {a: {} for a in axes}
    nbytes = {a: {} for a in axes}
    bat = "batch" if p_ > 1 else "data"

    def add(axis, op, count=1, b=0):
        if axis == "batch" and p_ == 1:
            axis = "data"
        if n[axis] == 1 or count == 0:
            return
        calls[axis][op] = calls[axis].get(op, 0) + count
        nbytes[axis][op] = nbytes[axis].get(op, 0) + int(b)

    def elt(name):
        return elts if isinstance(elts, int) else elts[name]

    if isinstance(cfg, GNNConfig):
        return _gnn(cfg, graph, regression, shapes, n, add, elt,
                    {"calls": calls, "bytes": nbytes}, frozen)
    if not isinstance(cfg, LMConfig):
        return _recsys(cfg, kind, specs, shapes, n, add, elt, batch, candidates, k,
                       {"calls": calls, "bytes": nbytes}, frozen)

    grad = kind == "train"
    if act is None:
        act = elt("embed")
    if kind == "decode":
        b_split = cache_spec is not None and cache_spec[1] is not None
        t_split = cache_spec is not None and cache_spec[2] is not None
        rows = batch // dp if b_split else batch
        tok = rows
    else:
        if batch % dp:
            raise ValueError(f"a batch of {batch} rows cannot be split over {dp} ranks")
        rows = batch // dp
        tok = rows * seq
    d_model = cfg.d_model

    def split(names):  # sharding.model_split
        return t_ > 1 and all(MODEL in specs[nm] for nm in names)

    def heads(names, counts):  # attention._heads_axis
        return split(names) and all(c % t_ == 0 for c in counts)

    def read(name, local, replay=False):
        shape = list(shapes[name])
        e = elt(name)
        for dim, ax in enumerate(specs[name]):
            if ax == FSDP and d_ > 1:
                size = int(np.prod(shape)) * e
                add("data", "all_gather", 1 + replay, size * (1 + replay))
                if grad:
                    add("data", "reduce_scatter", 1, size * d_)
                shape[dim] *= d_
            elif ax == MODEL and not local and t_ > 1:
                add("model", "all_gather", 1 + replay, int(np.prod(shape)) * e * (1 + replay))
                shape[dim] *= t_

    x_bytes = tok * d_model * act

    def attention(prefix, replay):
        if cfg.mla:
            m = cfg.mla
            hs = heads([f"{prefix}.attn.{w}" for w in _MLA_HEADS], (cfg.n_heads,))
            for w in _MLA_HEADS:
                read(f"{prefix}.attn.{w}", hs, replay)
            for w in _MLA_REST:
                read(f"{prefix}.attn.{w}", True, replay)
            for w, width in (("w_dq", m.q_lora_rank), ("w_dkv", m.kv_lora_rank)):
                if split([f"{prefix}.attn.{w}"]):
                    add("model", "all_gather", 1 + replay, tok * width // t_ * act * (1 + replay))
                    if grad:
                        add("model", "all_reduce", 1, x_bytes)
            if kind == "decode" and t_split and t_ > 1:
                if hs:  # every head's absorbed query and rope query
                    add("model", "all_gather", 1,
                        rows * cfg.n_heads // t_ * (m.kv_lora_rank + m.qk_rope_dim) * act)
                add("model", "all_gather", 1, rows * cfg.n_heads * (m.kv_lora_rank + 2) * 4)
            if hs:
                add("model", "all_reduce", 1 + replay, x_bytes * (1 + replay))
                if grad:  # q_lat, c, k_rope's gradients
                    add("model", "all_reduce", 3,
                        tok * (m.q_lora_rank + m.kv_lora_rank + m.qk_rope_dim) * act)
            return
        h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        hs = heads([f"{prefix}.attn.{w}" for w in _GQA], (h, hk))
        for w in _GQA:
            read(f"{prefix}.attn.{w}", hs, replay)
        if kind == "decode":
            ts = t_split and t_ > 1
            if hs:  # the new token's heads (k, v; q too where split in time)
                add("model", "all_gather", 1, rows * ((h if ts else 0) + 2 * hk) // t_ * dh * act)
            if ts:
                add("model", "all_gather", 1, rows * h * (dh + 2) * 4)
        if hs:
            add("model", "all_reduce", 1 + replay, x_bytes * (1 + replay))
            if grad:
                add("model", "all_reduce", 1, x_bytes)

    def mlp(prefix, replay):
        names = [f"{prefix}.mlp.{w}" for w in _MLP]
        sp = split(names)
        for nm in names:
            read(nm, sp, replay)
        if sp:
            add("model", "all_reduce", 1 + grad, x_bytes * (1 + grad))

    g_total = groups
    if cfg.moe and g_total is None:
        g_total = moe_mod._n_groups(batch * (seq if kind != "decode" else 1))
    g_loc = None
    if cfg.moe:
        replicated = kind == "decode" and not b_split
        g_loc = g_total if replicated else g_total // dp

    def moe_layer(prefix, replay):
        names = [f"{prefix}.moe.{w}" for w in _EXPERTS]
        sp = split(names)
        read(f"{prefix}.moe.router", sp, replay)
        for nm in names:
            read(nm, sp, replay)
        if sp:
            t_loc = tok // g_loc
            cap = moe_mod._capacity(t_loc, cfg.moe)
            e_loc = cfg.moe.n_experts // t_
            size = g_loc * e_loc * cap * d_model * act
            add("model", "all_gather", 1 + replay, size * (1 + replay))
            if grad:
                add("model", "all_reduce", 1, x_bytes)
        if cfg.moe.n_shared:
            names = [f"{prefix}.moe.shared.{w}" for w in _MLP]
            ss = split(names)
            for nm in names:
                read(nm, ss, replay)
            if ss:
                add("model", "all_reduce", 1 + grad, x_bytes * (1 + grad))

    vocab = split(["embed"])
    head = "embed" if cfg.tie_embeddings else "head"

    def embed():
        read("embed", vocab)
        if vocab:
            add("model", "all_reduce", 1, x_bytes)

    def logits_and_loss(rows_s):
        read(head, vocab)
        if vocab:
            add("model", "all_reduce", 1, x_bytes)  # h's gradient
            add("model", "all_reduce", 3, 3 * rows_s * 4)  # max, sum of exps, target

    embed()
    n_dense = cfg.first_k_dense if cfg.moe else cfg.n_layers
    remat = bool(cfg.remat) and grad
    for key, count, is_moe in (("dense_layers", n_dense, False),
                               ("moe_layers", cfg.n_moe_layers, True)):
        for i in range(count):
            attention(f"{key}.{i}", remat)
            (moe_layer if is_moe else mlp)(f"{key}.{i}", remat)
    if grad:
        logits_and_loss(tok)
        if cfg.mtp_depth:
            embed()
            read("mtp.proj", True)
            if split(["mtp.proj"]):
                add("model", "all_gather", 1, tok * d_model // t_ * act)
                add("model", "all_reduce", 1, 2 * x_bytes)  # proj's input gradient
            attention("mtp.layer", False)
            mlp("mtp.layer", False)
            logits_and_loss(rows * (seq - 1))
    else:
        read(head, vocab)
        if vocab:  # the last position's vocab blocks
            add("model", "all_gather", 1, rows * cfg.vocab // t_ * act)
        if kind == "prefill" or b_split:
            add(bat, "all_gather", 1, rows * 8)  # the next tokens, int64
    if cfg.moe and kind != "decode":
        add(bat, "all_gather", 1, cfg.n_moe_layers * g_loc * cfg.moe.n_experts * 4)
    if grad:
        _buckets(specs, shapes, elt, d_, add, bat, frozen)
        add(bat, "all_reduce", 1, 4)  # the loss
        if d_ > 1 and any(FSDP in s for s in specs.values()):
            add("data", "all_reduce", 1, 8)  # the norm
        if t_ > 1 and any(MODEL in s for s in specs.values()):
            add("model", "all_reduce", 1, 8)
    return {"calls": calls, "bytes": nbytes}


def _buckets(specs, shapes, elt, d_, add, bat, frozen) -> None:
    """``all_reduce_grads``' buckets: the leaves ``data`` leaves whole over
    the batch axes, the FSDP leaves over ``pod``; per dtype, at most
    ``GRAD_BUCKET_BYTES`` each."""
    whole, fsdp = {}, {}
    for name, spec in specs.items():
        if name in frozen:
            continue
        e = elt(name)
        into = fsdp if (FSDP in spec and d_ > 1) else whole
        into[e] = into.get(e, 0) + int(np.prod(shapes[name]))
    for axis, by_elt in ((bat, whole), ("pod", fsdp)):
        for e, count in by_elt.items():
            cap = max(1, sharding.GRAD_BUCKET_BYTES // e)
            add(axis, "all_reduce", math.ceil(count / cap), count * e)


def _recsys(cfg, kind, specs, shapes, n, add, elt, batch, candidates, k, out,
            frozen) -> dict:
    """DeepFM's collectives (see ``derived_collectives``)."""
    dp, t_ = n["batch"], n["model"]
    bat = "batch" if n["pod"] > 1 else "data"
    f, d = cfg.n_sparse, cfg.embed_dim
    vocab = t_ > 1 and MODEL in specs["tables"]
    first = t_ > 1 and MODEL in specs["first_order"]
    if kind == "retrieval":
        if vocab:
            add("model", "all_reduce", 1, batch * f * d * 4)
        if candidates % dp == 0:
            k_loc = min(k, candidates // dp)
            add(bat, "all_gather", 2, batch * k_loc * (4 + 8))
        return out
    split = batch % dp == 0
    rows = batch // dp if split else batch
    if vocab:
        add("model", "all_reduce", 1, rows * f * d * 4)
    if first:
        add("model", "all_reduce", 1, rows * f * 4)
    if kind == "serve":
        if split:
            add(bat, "all_gather", 1, rows * 4)
        return out
    _buckets(specs, shapes, elt, n["data"], add, bat, frozen)
    add(bat, "all_reduce", 1, 4)  # the loss
    if vocab or first:
        add("model", "all_reduce", 1, 8)  # the norm
    return out


def _gnn(cfg, graph, regression, shapes, n, add, elt, out, frozen) -> dict:
    """A GNN train step's collectives (see ``derived_collectives``)."""
    r = n["flat"]
    nodes, edges, g = graph["n"], graph["e"], graph["n_graphs"]
    d = cfg.d_hidden

    def gather(width, rows=nodes, elt_=4, grad=True):  # GraphShard.gather
        add("flat", "all_gather", 1, rows // r * width * elt_)
        if grad:
            add("flat", "reduce_scatter", 1, rows * width * elt_)

    def scatter(width, rows=nodes, grad=True):  # reduce_scatter_rows
        add("flat", "reduce_scatter", 1, rows * width * 4)
        if grad:
            add("flat", "all_gather", 1, rows // r * width * 4)

    def extremum(width):  # all-reduce; backward: the gradient and the ties
        add("flat", "all_reduce", 2, 2 * nodes * width * 4)
        add("flat", "all_gather", 1, nodes // r * width * 4)

    if cfg.kind == "pna":
        aggs = tuple(cfg.extra["aggregators"])
        fused = "mean" in aggs and "std" in aggs
        sums = 2 * fused + sum({"sum": 1, "mean": 1, "std": 2}.get(a, 0) for a in aggs
                               if not (fused and a in ("mean", "std")))
        scatter(1, grad=False)  # the degrees
        for _ in range(cfg.n_layers):
            gather(d)
            for _ in range(sums):
                scatter(d)
            for _ in range(sum(a in ("max", "min") for a in aggs)):
                extremum(d)
    elif cfg.kind == "meshgraphnet":
        for _ in range(cfg.n_layers):
            gather(d)
            scatter(d)
    elif cfg.kind == "mace":
        gather(3, grad=False)  # the positions
        for _ in range(cfg.n_layers):
            gather(9 * d)
            scatter(9 * d)
    else:  # dimenet
        nb = cfg.extra["n_bilinear"]
        gather(1, rows=edges, elt_=8, grad=False)  # the ranks' edge orders
        gather(3, grad=False)  # the positions
        gather(d)  # the embedded species
        gather(3, rows=edges, grad=False)  # the edge vectors
        for _ in range(cfg.n_layers):
            gather(nb, rows=edges)
            scatter(nb, rows=edges)
            scatter(d)
    if regression:
        add("flat", "all_reduce", 1, g * 4)  # the per-graph readout
    else:
        add("flat", "all_reduce", 1, 8)  # the masked mean's numerator and count
    by_elt: dict = {}
    for name, shape in shapes.items():
        if name not in frozen:
            by_elt[elt(name)] = by_elt.get(elt(name), 0) + int(np.prod(shape))
    for e, count in by_elt.items():
        cap = max(1, sharding.GRAD_BUCKET_BYTES // e)
        add("flat", "all_reduce", math.ceil(count / cap), count * e)
    return out


def derived_for(bundle, model, mesh, **sizes) -> dict:
    """``derived_collectives`` for ``bundle``'s step on ``mesh`` (a
    ``HostMesh``), reading the placed ``model``'s fitted specs, the rank's
    parameter shapes and their element bytes; ``sizes`` overrides the
    bundle's ``info`` (a batch or length cut from the published one)."""
    info = {**bundle.info, **sizes}
    params = dict(model.named_parameters())
    return derived_collectives(
        model.cfg, info["kind"], model.placement.specs,
        {nm: tuple(p.shape) for nm, p in params.items()}, mesh_sizes(mesh),
        batch=info.get("batch"), seq=info.get("seq"),
        elts={nm: p.element_size() for nm, p in params.items()},
        cache_spec=info.get("cache_spec"), candidates=info.get("candidates"),
        k=info.get("k"), frozen=frozenset(nm for nm, p in params.items() if not p.requires_grad),
        graph=info.get("graph"), regression=info.get("regression", False))


def by_op(derived: dict, mesh_sizes_: dict) -> dict:
    """A derived count's calls and ring wire bytes summed over the axes,
    per op, and the wire bytes a device sends in all (the reference's
    ``parse_collectives`` fields)."""
    n = _axis_sizes(mesh_sizes_)
    counts, wire = {}, {}
    for axis, ops in derived["calls"].items():
        for op, c in ops.items():
            counts[op] = counts.get(op, 0) + c
            wire[op] = wire.get(op, 0.0) + wire_bytes(op, derived["bytes"][axis][op], n[axis])
    return {"counts": counts, "by_op": wire, "wire_bytes_per_device": sum(wire.values())}


# ---------------------------------------------------------------------------
# the reckoning at the production meshes
# ---------------------------------------------------------------------------


def _meta_model(spec, shape_name: str):
    """The cell's model at its published config on meta tensors (a GNN's
    input and output widths are its shape's)."""
    from repro_torch.launch.steps import _gnn_sizes, gnn_model, gnn_regression
    from repro_torch.models.recsys import DeepFM
    from repro_torch.models.transformer import Transformer

    with torch.device("meta"):
        if spec.family == "lm":
            return Transformer(spec.config, device="meta")
        if spec.family == "gnn":
            shape = spec.shapes()[shape_name]
            return gnn_model(spec.config, _gnn_sizes(shape, reduced=False),
                             gnn_regression(spec.config, shape), device="meta")
        return DeepFM(spec.config, device="meta")


def _model_key(arch: str, shape_name: str):
    """What a cell's meta model depends on: the architecture, and a GNN's
    shape."""
    return (arch, shape_name) if ARCHS[arch].family == "gnn" else arch


def _local(shape, spec, sizes) -> tuple:
    return tuple(s // (axis_size(sizes, ax) if ax else 1) for s, ax in zip(shape, spec))


def _cell_layout(arch: str, shape_name: str, layout, model=None) -> dict:
    """What the reckoning reads: the fitted specs, the rank's shapes and
    element bytes, and the step's sizes, at the published config
    (``model``: the architecture's meta model, where the caller has it)."""
    from repro_torch.launch.steps import _gnn_sizes, gnn_regression, serving_fsdp
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import cache_spec

    spec = ARCHS[arch]
    shape = spec.shapes()[shape_name]
    cfg = spec.config
    model = _meta_model(spec, shape_name) if model is None else model
    sizes = mesh_sizes(layout)
    if spec.family == "lm":
        specs = sharding.lm_param_specs(model)
        if shape.kind != "train" and not serving_fsdp(cfg, layout):
            specs = {nm: tuple(None if ax == FSDP else ax for ax in s) for nm, s in specs.items()}
    elif spec.family == "gnn":
        specs = sharding.gnn_param_specs(model)
    else:
        specs = sharding.recsys_param_specs(model)
    specs = fit_specs(specs, model, layout)
    params = dict(model.named_parameters())
    out = {"cfg": cfg, "kind": shape.kind, "specs": specs,
           "shapes": {nm: _local(p.shape, specs[nm], sizes) for nm, p in params.items()},
           "elts": {nm: p.element_size() for nm, p in params.items()}, "cache": {},
           "frozen": frozenset(nm for nm, p in params.items() if not p.requires_grad)}
    if spec.family == "lm":
        out.update(batch=shape.global_batch, seq=shape.seq_len)
        if shape.kind == "decode":
            c_spec = cache_spec(cfg, shape.global_batch, shape.seq_len, layout)
            out["cache_spec"] = c_spec
            t = shape.seq_len if cfg.sliding_window is None else min(shape.seq_len,
                                                                     cfg.sliding_window)
            n_dense = cfg.first_k_dense if cfg.moe else cfg.n_layers
            for key, n_l in (("dense", n_dense), ("moe", cfg.n_moe_layers)):
                for nm, s in attn.cache_shapes(cfg, shape.global_batch, t).items():
                    if n_l:
                        full = (n_l, *s)
                        out["cache"][f"{key}.{nm}"] = _local(
                            full, tuple(c_spec) + (None,) * (len(full) - 3), sizes)
    elif spec.family == "gnn":
        out.update(kind="train", graph=_gnn_sizes(shape, reduced=False),
                   regression=gnn_regression(cfg, shape))
    else:
        out.update(batch=shape.batch, candidates=shape.n_candidates or None,
                   k=100 if shape.kind == "retrieval" else None)
    return out


def state_bytes_per_rank(arch: str, shape_name: str, layout, *, lay: dict | None = None) -> dict:
    """Each rank's state bytes at the published config on ``layout`` (a
    ``MeshLayout`` or ``HostMesh``): the parameters' fitted shards, a train
    kind's two AdamW moments (float32, bfloat16 under ``REPRO_BF16_MOMENTS``)
    and step count (int32), a decode kind's bfloat16 cache shard."""
    lay = lay or _cell_layout(arch, shape_name, layout)
    params = sum(int(np.prod(s)) * lay["elts"][nm] for nm, s in lay["shapes"].items())
    opt = 0
    if lay["kind"] == "train":
        moment = 2 if (ARCHS[arch].family == "lm" and os.environ.get("REPRO_BF16_MOMENTS")) else 4
        opt = 2 * moment * sum(int(np.prod(s)) for s in lay["shapes"].values()) + 4
    cache = 2 * sum(int(np.prod(s)) for s in lay["cache"].values())
    return {"params": params, "opt": opt, "cache": cache, "total": params + opt + cache}


def reckon_cell(arch: str, shape_name: str, mesh_kind: str, *, model=None) -> dict:
    """One cell's record at a production mesh (``"single"`` or
    ``"multi"``): its per-rank state bytes and one step's derived
    collectives with their ring wire bytes (``model``: the architecture's
    meta model, built here where None)."""
    from repro_torch.launch.mesh import make_production_mesh

    layout = make_production_mesh(multi_pod=mesh_kind == "multi")
    lay = _cell_layout(arch, shape_name, layout, model)
    derived = derived_collectives(
        lay["cfg"], lay["kind"], lay["specs"], lay["shapes"], layout.shape,
        batch=lay.get("batch"), seq=lay.get("seq"), elts=lay["elts"],
        cache_spec=lay.get("cache_spec"), candidates=lay.get("candidates"), k=lay.get("k"),
        frozen=lay["frozen"], graph=lay.get("graph"), regression=lay.get("regression", False))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "n_devices": layout.size,
        "axes": layout.shape, "ok": True,
        "state_bytes_per_rank": state_bytes_per_rank(arch, shape_name, layout, lay=lay),
        "collectives": {**by_op(derived, layout.shape), "per_axis": derived},
        "not_reckoned": NOT_RECKONED,
    }


def cells(arch=None, shape=None, mesh=None):
    """``(arch, shape, mesh kind or None, skip reason or None)`` for every
    cell, the reference's order: each architecture's shapes, then the ones
    it skips (one record each), both meshes a shape."""
    for a, spec in ARCHS.items():
        if arch and a != arch:
            continue
        for s in tuple(spec.shape_names) + tuple(spec.skip_shapes):
            if shape and s != shape:
                continue
            if s in spec.skip_shapes:
                yield a, s, None, spec.skip_shapes[s]
                continue
            for kind in ("single", "multi"):
                if mesh and kind != mesh:
                    continue
                yield a, s, kind, None


def _record(arch: str, shape: str, kind, skip, models: dict) -> dict:
    """A cell's record: a skip (``kind`` None) or the reckoning
    (``models``: the meta models built so far, by ``_model_key``)."""
    if kind is None:
        return {"arch": arch, "shape": shape, "skipped": skip}
    key = _model_key(arch, shape)
    if key not in models:
        models[key] = _meta_model(ARCHS[arch], shape)
    return reckon_cell(arch, shape, kind, model=models[key])


def reckon_all(arch=None, shape=None, mesh=None):
    """``(arch, shape, mesh kind, record)`` for every cell ``cells`` names;
    each meta model (a GNN's, per shape) is built once."""
    models = {}
    for a, s, kind, skip in cells(arch, shape, mesh):
        yield a, s, kind, _record(a, s, kind, skip, models)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=ART_DIR, help="the records' directory")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    failures, done, models = [], 0, {}
    for arch, shape, kind, skip in cells(args.arch, args.shape, args.mesh):
        path = os.path.join(args.out, f"{arch}__{shape}__{kind or 'skip'}.json")
        if kind is not None and os.path.exists(path) and not args.force:
            continue
        try:
            result = _record(arch, shape, kind, skip, models)
        except Exception as e:  # a cell's failure is recorded; the others go on
            traceback.print_exc()
            result = {"arch": arch, "shape": shape, "mesh": kind, "ok": False,
                      "error": str(e)[:2000]}
            failures.append((arch, shape, kind))
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        if kind is None:
            print(f"[dryrun] {arch}:{shape} SKIP ({skip})", flush=True)
            continue
        done += 1
        if result["ok"]:
            st, co = result["state_bytes_per_rank"], result["collectives"]
            print(f"[dryrun] {arch}:{shape} mesh={kind} OK "
                  f"state/dev={st['total'] / 2**30:.2f}GiB "
                  f"coll/dev={co['wire_bytes_per_device'] / 2**30:.3f}GiB", flush=True)
    if failures:
        print(f"[dryrun] FAILURES: {failures}", flush=True)
        return 1
    print(f"[dryrun] all requested cells done ({done} written)", flush=True)
    return 0


# ---------------------------------------------------------------------------
# the check on host meshes
# ---------------------------------------------------------------------------


def stats_delta(before: dict, after: dict) -> dict:
    """Per axis, the calls and bytes of each collective between two
    ``HostMesh.stats`` snapshots (those that ran)."""
    out = {}
    for axis in after:
        ran = [op for op in after[axis]["calls"]
               if after[axis]["calls"][op] != before[axis]["calls"].get(op, 0)]
        out[axis] = {key: {op: after[axis][key][op] - before[axis][key].get(op, 0) for op in ran}
                     for key in ("calls", "bytes")}
    return out


def measured_matches(measured: dict, derived: dict, steps: int = 1) -> bool:
    """Whether the measured calls and bytes of ``steps`` steps equal
    ``steps`` times the derived ones on every axis (an axis either side
    leaves out issued none)."""
    for a in set(measured) | set(derived["calls"]):
        got = measured.get(a, {"calls": {}, "bytes": {}})
        for key in ("calls", "bytes"):
            want = {op: v * steps for op, v in derived[key].get(a, {}).items()}
            if got[key] != want:
                return False
    return True


def cell_on_rank(arch: str, shape_name: str, mesh, *, seed: int = 0, config=None) -> dict:
    """This rank's share of one step of the cell's reduced bundle on
    ``mesh`` (every rank of the mesh calls it at once): the measured
    collectives beside the derived ones, and the flash kernel's launches
    in the step (the wrapper's count is read before and after, not
    reset)."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels.flash_attention import flash_fwd
    from repro_torch.launch.steps import build_bundle

    bundle = build_bundle(arch, shape_name, reduced=config is None, config=config, mesh=mesh)
    state = bundle.init_state_fn(seed)
    batch = make_batch(bundle.abstract_inputs, seed=seed, step=0, bounds=bundle.input_bounds,
                       device=mesh.device)
    launches = flash_fwd.launches
    before = mesh.stats()
    bundle.step_fn(state, batch)
    measured = stats_delta(before, mesh.stats())
    derived = derived_for(bundle, state["params"], mesh)
    return {"rank": mesh.rank, "shape": mesh.shape, "measured": measured, "derived": derived,
            "matches": measured_matches(measured, derived),
            "flash_launches": flash_fwd.launches - launches}


def _cell_rank(arch: str, shape_name: str, dims: tuple, seed: int, device: str) -> dict:
    from repro_torch.launch.mesh import make_mesh

    p, d, t = dims
    return cell_on_rank(arch, shape_name, make_mesh(pod=p, data=d, model=t, device=device),
                        seed=seed)


def run_cell_on_ranks(arch: str, shape_name: str, mesh: tuple, *, seed: int = 0,
                      timeout: float = 300.0, device=None):
    """One step of the cell's reduced bundle on a ``(P, D, T)`` host mesh
    of ranks (``dist.run_ranks``; ``device``: the card unless the caller
    asks for the CPU, whose ranks join over gloo): each rank's
    ``cell_on_rank`` result, in rank order."""
    from repro_torch.dist import run_ranks

    p, d, t = (1, *mesh) if len(mesh) == 2 else mesh
    device = torch.device("cuda" if device is None else device).type
    return run_ranks(_cell_rank, p * d * t, device=device, timeout=timeout,
                     args=(arch, shape_name, (p, d, t), seed, device))


if __name__ == "__main__":
    raise SystemExit(main())
