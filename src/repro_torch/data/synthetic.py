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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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
