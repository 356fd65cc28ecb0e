"""Deterministic synthetic batches matching a bundle's abstract inputs
(``repro.data.synthetic`` counterpart).

A batch is a pure function of ``(seed, step)`` (and the device's kind),
so a restarted run resumes mid-stream with no state.  Index inputs are
drawn within valid ranges (vocab, node counts); graph edges form a ring
plus random chords.  Index draws come from numpy's ``default_rng`` where
the reference uses ``jax.random``, so the values differ from its own but
follow the same recipe; ``graph_batch``'s edges are the reference's numpy
draws, equal.  Float inputs (node features, positions) are drawn on the
batch's device by a ``torch.Generator`` seeded from ``(seed, step,
input)``: a full-size graph batch holds a hundred million of them, which
the host would take seconds to draw each step.  The CPU's stream and a
card's differ.

Data-parallel ranks all draw the global batch and take their rows of it
(``shard_batch``, by their index on the batch axes, pod-major), so a shard
is exactly rows of the one-rank batch.  A graph batch is split over the
flattened axis instead (every rank of the mesh, in rank order), as the
reference's GNN input specs say: its edge, triplet and node arrays each in
contiguous blocks, the ids in them still global.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.dist.sharding import dp_size
from repro_torch.models.common import model_device


class InputSpec(NamedTuple):
    """One input's shape and torch dtype (the port's ``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def make_batch(abstract_inputs: dict, *, seed: int, step: int, bounds: dict | None = None,
               device="cuda") -> dict:
    """A batch of tensors on ``device`` for ``{name: InputSpec}``; ``bounds``
    gives per-input exclusive upper bounds for int draws (defaults derived
    from names)."""
    device = model_device(device)
    bounds = bounds or {}
    out = {}
    for i, (name, spec) in enumerate(sorted(abstract_inputs.items())):
        rng = np.random.default_rng([seed, step, i])
        shape, dtype = tuple(spec.shape), spec.dtype
        if dtype == torch.bool:
            arr = np.ones(shape, bool)
        elif name == "tokens" and len(shape) == 2 and shape[1] > 1:
            # learnable stream: per-row arithmetic progressions mod vocab
            hi = bounds.get(name, _default_bound(name))
            off = rng.integers(0, hi, (shape[0], 1))
            stride = rng.integers(1, 8, (shape[0], 1))
            arr = (off + stride * np.arange(shape[1])[None, :]) % hi
        elif name == "labels" and dtype.is_floating_point:
            if "ids" in out and out["ids"].shape[0] == shape[0]:
                # learnable CTR signal: label = parity of the first field id
                arr = out["ids"][:, 0, 0].cpu().numpy() % 2
            else:
                arr = rng.random(shape) < 0.35
        elif not dtype.is_floating_point:
            hi = bounds.get(name, _default_bound(name))
            arr = np.zeros(shape, np.int64) if shape == () else rng.integers(0, hi, shape)
        else:
            gen = torch.Generator(device=device).manual_seed(
                int(np.random.SeedSequence([seed, step, i]).generate_state(1)[0]))
            out[name] = torch.randn(shape, generator=gen, device=device).to(dtype)
            continue
        out[name] = torch.as_tensor(np.asarray(arr), device=device).to(dtype)
    return out


#: a graph batch's arrays split over the flattened axis (the reference's
#: ``P(dp + ("model",))`` input specs); a regression's per-graph ``labels``
#: stay whole (``P(None)``)
GRAPH_SPLIT = ("edge_src", "edge_dst", "edge_mask", "edge_feat", "trip_kj", "trip_ji",
               "trip_mask", "x", "species", "positions", "graph_id", "label_mask")


def _shard_graph(batch: dict, mesh) -> dict:
    """This rank's share of a global graph batch on ``mesh``'s flattened
    axis (``HostMesh.flat``: R = P*D*T ranks, index r): the rank takes block
    r of R contiguous blocks of each edge, triplet and node array (and of
    ``labels`` where they are per node, with a ``label_mask``), and an
    array whose length R does not divide stays whole, as the reference's
    ``_fit_specs`` leaves it.  Edge endpoints and triplet edge ids keep
    their global values."""
    axis = mesh.flat
    r, n_ranks = axis.rank, axis.world_size
    split = GRAPH_SPLIT + (("labels",) if "label_mask" in batch else ())
    out = {}
    for name, t in batch.items():
        if name in split and t.shape[0] % n_ranks == 0:
            rows = t.shape[0] // n_ranks
            t = t[r * rows:(r + 1) * rows]
        out[name] = t
    return out


def shard_batch(batch: dict, mesh, *, replicate_uneven: bool = False) -> dict:
    """This batch rank's rows of a global batch: the rank at index r of the
    D = pod x data batch ranks (pod-major, ``HostMesh.batch``) takes rows
    ``[r*B/D, (r+1)*B/D)`` of every input (the reference's ``P(("pod",
    "data"), ...)`` placement; the model axis shares them).  A batch of B
    rows that D ranks cannot split evenly raises, or, with
    ``replicate_uneven`` (the reference's serving specs: ``P(None, ...)``
    where B does not divide), is returned whole to every rank.  A graph
    batch (one with ``edge_src``) is split over the flattened axis instead
    (``_shard_graph``)."""
    if "edge_src" in batch:
        return _shard_graph(batch, mesh)
    d = dp_size(mesh)
    rows = {int(t.shape[0]) for t in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"a batch's inputs disagree on their rows: {sorted(rows)}")
    (b,) = rows
    if b % d:
        if replicate_uneven:
            return batch
        raise ValueError(f"a batch of {b} rows cannot be split over {d} data ranks")
    lo = mesh.batch.rank * (b // d)
    return {name: t[lo:lo + b // d] for name, t in batch.items()}


def _default_bound(name: str) -> int:
    return {
        "tokens": 1000,
        "labels": 2,
        "ids": 1000,
        "species": 10,
        "graph_id": 4,
    }.get(name, 256)


def graph_batch(abstract_inputs: dict, *, seed: int, step: int, n_nodes: int,
                n_classes: int = 64, device="cuda") -> dict:
    """A synthetic graph batch: ring + random chord edges (valid indices)."""
    rng = np.random.default_rng(seed * 100003 + step)
    out = make_batch(
        abstract_inputs, seed=seed, step=step,
        bounds={"labels": n_classes, "species": 10, "graph_id": 4}, device=device,
    )
    dev = model_device(device)
    e = abstract_inputs["edge_src"].shape[0]
    src = rng.integers(0, n_nodes, e)
    dst = np.concatenate([(src[: e // 2] + 1) % n_nodes, rng.integers(0, n_nodes, e - e // 2)])
    out["edge_src"] = torch.as_tensor(src.astype(np.int32), device=dev)
    out["edge_dst"] = torch.as_tensor(dst.astype(np.int32), device=dev)
    if "trip_kj" in out:
        t = abstract_inputs["trip_kj"].shape[0]
        out["trip_kj"] = torch.as_tensor(rng.integers(0, e, t).astype(np.int32), device=dev)
        out["trip_ji"] = torch.as_tensor(rng.integers(0, e, t).astype(np.int32), device=dev)
    return out
