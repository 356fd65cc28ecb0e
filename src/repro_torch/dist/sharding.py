"""The graph partition axis as a mesh of processes (``repro.dist.sharding``'s
``partition_mesh`` and ``parts`` specs, ported to ``torch.distributed``).

A ``PartitionMesh`` is one rank's view of the mesh the traversal engine
shards its device-major vertex layout over: the world size, this rank, the
process group, the ``torch.device`` this rank computes on, and the backend's
name.  Where the JAX package writes ``P(None, "parts")`` for the carried
state, a rank here simply holds its own ``[S, n_pad]`` block.

The mesh also owns the collectives the engine runs, so every one of them is
counted and timed in one place (``CollectiveStats``):

  * ``all_reduce`` (``MAX`` for the closure and boundary syncs, ``SUM`` for
    the counter epilogue), ``all_to_all`` (the static wire and mirror
    planes), ``all_to_all_v`` (uneven splits: state relayout and shard
    moves) and ``all_gather`` (state back to global vertex order).
  * **Transport.**  Every backend takes the tensors where they lie
    (``"direct"``): NCCL between cards, gloo on the CPU, and gloo with
    CUDA tensors -- the case of several ranks on one card, where NCCL
    refuses to run -- which copies them through host memory itself.

``partition_mesh(1)`` outside a launched rank is a legal one-rank mesh; the
engine takes its dense path for it.

Data-parallel training (``launch.mesh.make_host_mesh``'s ``("data",
"model")`` mesh, ``launch.steps``) reads two more things here: ``dp_axes``
and ``dp_size``, the batch axes of a mesh and their ranks, and
``all_reduce_grads``, the data axis's gradient mean, summed bucket by
bucket through ``PartitionMesh.all_reduce`` so each call is counted.

The module also keeps the reference's parameter rule tables
(``lm_param_specs``, ``gnn_param_specs``, ``recsys_param_specs``) as data:
parameter name -> mesh-axis tuple.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class CollectiveStats:
    """Counts, bytes and host-clock seconds of one rank's collectives.

    ``calls`` and ``bytes`` are keyed by operation (``"all_reduce"``,
    ``"all_to_all"``, ``"all_to_all_v"``, ``"all_gather"``); ``seconds``
    spans each call until the backend returns.
    """

    calls: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    def add(self, op: str, nbytes: int, secs: float) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0) + int(nbytes)
        self.seconds += secs

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes), "seconds": self.seconds}


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor handed to the backend: bool payloads travel as uint8."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.view(torch.bool) if dtype == torch.bool else t


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionMesh:
    """One rank's view of the partition mesh (see the module docstring)."""

    world_size: int
    rank: int
    device: torch.device
    backend: str | None  # "nccl" | "gloo" | None (a one-rank mesh)
    group: Any = None  # the process group (None on a one-rank mesh)
    stats: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)

    #: how payloads reach the backend (see the module docstring)
    transport = "direct"

    @property
    def key(self) -> tuple:
        """Hashable identity for engine caches."""
        return (int(self.world_size), int(self.rank), str(self.backend), str(self.device))

    def describe(self) -> dict:
        return {
            "world_size": self.world_size, "rank": self.rank,
            "device": str(self.device), "backend": self.backend,
            "transport": self.transport,
        }

    # -- collectives ---------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, op: str = "max") -> torch.Tensor:
        """``MAX`` or ``SUM`` over the ranks; returns a new tensor."""
        red = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op]
        t0 = time.perf_counter()
        h = _wire(t).clone()  # the reduction is in place; the input stays
        dist.all_reduce(h, op=red, group=self.group)
        self.stats.add("all_reduce", h.numel() * h.element_size(), time.perf_counter() - t0)
        return _unwire(h, t.dtype)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``[D, ...]`` -> ``[D, ...]``: block ``j`` goes to rank ``j``, and
        block ``j`` of the result came from rank ``j``."""
        if t.shape[0] != self.world_size:
            raise ValueError(f"all_to_all wants [{self.world_size}, ...], got {tuple(t.shape)}")
        t0 = time.perf_counter()
        h = _wire(t)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=self.group)
        self.stats.add("all_to_all", h.numel() * h.element_size(), time.perf_counter() - t0)
        return _unwire(out, t.dtype)

    def all_to_all_v(
        self, t: torch.Tensor, send_counts: list[int], recv_counts: list[int]
    ) -> torch.Tensor:
        """Uneven all-to-all along dim 0: ``send_counts[j]`` leading rows of
        ``t`` (in rank order) go to rank ``j``; ``recv_counts[j]`` rows come
        back from rank ``j``."""
        t0 = time.perf_counter()
        h = _wire(t)
        out = h.new_empty((int(sum(recv_counts)), *h.shape[1:]))
        dist.all_to_all_single(
            out, h, [int(c) for c in recv_counts], [int(c) for c in send_counts],
            group=self.group,
        )
        self.stats.add("all_to_all_v", h.numel() * h.element_size(), time.perf_counter() - t0)
        return _unwire(out, t.dtype)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[...]`` on every rank -> ``[D, ...]`` (rank order)."""
        t0 = time.perf_counter()
        h = _wire(t)
        out = h.new_empty((self.world_size, *h.shape))
        dist.all_gather(list(out.unbind(0)), h, group=self.group)
        self.stats.add("all_gather", h.numel() * h.element_size(), time.perf_counter() - t0)
        return _unwire(out, t.dtype)

    def barrier(self) -> None:
        """Every rank waits here until all have arrived."""
        t0 = time.perf_counter()
        dist.barrier(group=self.group)
        self.stats.add("barrier", 0, time.perf_counter() - t0)

    def gather_host(self, a: np.ndarray) -> np.ndarray:
        """A small host array of the same shape and dtype on every rank ->
        ``[D, ...]`` on the host (``all_gather`` on this rank's device)."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return self.all_gather(t).cpu().numpy()


#: the device each launched rank computes on (set by ``dist.launch``)
_RANK_DEVICE: torch.device | None = None


def partition_mesh(n_devices: int | None = None, *, device=None) -> PartitionMesh:
    """This rank's ``PartitionMesh`` over the ``parts`` axis.

    Inside a rank started by ``dist.launch.run_ranks`` (or any initialized
    default process group) the mesh spans every rank of the default group;
    ``n_devices``, when given, must equal the world size.  Outside one, only
    a one-rank mesh exists (``n_devices`` of None or 1).  The rank computes
    on ``device``; by default on the card ``run_ranks`` gave it, else on the
    current CUDA device -- the port runs on the card unless asked for the
    CPU, and without CUDA only ``device="cpu"`` is legal.
    """
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and int(n_devices) != world:
            raise ValueError(
                f"asked for a {n_devices}-rank mesh inside a {world}-rank process group"
            )
        dev = torch.device(device) if device is not None else _RANK_DEVICE
        if dev is None:
            dev = torch.device("cuda", torch.cuda.current_device()) if (
                torch.cuda.is_available()
            ) else torch.device("cuda")
        _check_device(dev)
        return PartitionMesh(
            world, dist.get_rank(), dev, dist.get_backend(), group=dist.group.WORLD
        )
    if n_devices not in (None, 1):
        raise ValueError(
            f"a {n_devices}-rank mesh needs one process per rank: start them with "
            "repro_torch.dist.run_ranks (no process group is initialized here)"
        )
    dev = torch.device(device if device is not None else "cuda")
    _check_device(dev)
    return PartitionMesh(1, 0, dev, None)


def _check_device(dev: torch.device) -> None:
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA mesh was requested but CUDA is not available; pass device='cpu'"
        )


# ---------------------------------------------------------------------------
# the data axes and the gradient sum over them
# ---------------------------------------------------------------------------

#: batch-like axes (the reference's ``_BATCH_AXES`` less ``pod``, which only
#: its production mesh has)
_BATCH_AXES = ("data",)

#: the most bytes one gradient all-reduce carries: ``all_reduce`` clones its
#: input, so a bucket costs twice its size on the device while it is summed
GRAD_BUCKET_BYTES = 256 << 20


def dp_axes(mesh) -> tuple[str, ...]:
    """The batch/data-parallel axes present in ``mesh`` (always a tuple)."""
    return tuple(a for a in _BATCH_AXES if a in mesh.axis_names)


def dp_size(mesh) -> int:
    """The ranks along ``mesh``'s data axis: how many shards a batch takes."""
    return mesh.data.world_size


def all_reduce_grads(named_grads: dict, params: dict, mesh: PartitionMesh) -> dict:
    """The mean over ``mesh``'s ranks of each rank's gradients.

    ``named_grads`` maps each name of ``params`` (name -> parameter, in an
    order every rank shares) to its gradient, or None where autograd gave
    none on this rank: it counts as zeros, so every rank sends the same
    bytes.  The gradients of one dtype are laid end to end and cut into
    buckets of at most ``GRAD_BUCKET_BYTES``, a tensor split across two
    where it straddles a cut; each bucket is summed by one
    ``mesh.all_reduce(op="sum")`` in that dtype, divided by the rank count
    and written back into the gradients, in place.  Returns name ->
    gradient, a zero tensor where the rank had None.
    """
    out = {}
    for name, p in params.items():
        g = named_grads.get(name)
        out[name] = torch.zeros_like(p) if g is None else g.contiguous()
    by_dtype: dict = {}
    for g in out.values():
        by_dtype.setdefault(g.dtype, []).append(g.view(-1))
    for dtype in sorted(by_dtype, key=str):  # one order on every rank
        cap = max(1, GRAD_BUCKET_BYTES // torch.empty((), dtype=dtype).element_size())
        pieces, n = [], 0
        for flat in by_dtype[dtype]:
            off = 0
            while off < flat.numel():
                take = min(flat.numel() - off, cap - n)
                pieces.append(flat[off:off + take])
                n += take
                off += take
                if n == cap:
                    _mean_bucket(pieces, mesh)
                    pieces, n = [], 0
        if pieces:
            _mean_bucket(pieces, mesh)
    return out


def _mean_bucket(pieces: list, mesh: PartitionMesh) -> None:
    bucket = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    total = mesh.all_reduce(bucket, op="sum")
    total.div_(mesh.world_size)
    off = 0
    for piece in pieces:
        piece.copy_(total[off:off + piece.numel()])
        off += piece.numel()


# ---------------------------------------------------------------------------
# parameter spec rule tables (``repro.dist.sharding``'s, as data)
# ---------------------------------------------------------------------------
#
# Each maps a module's parameter names to a tuple of mesh axes, one entry a
# dimension: ``MODEL`` (the tensor/expert-parallel axis), ``FSDP`` (the
# batch axis parameters are sharded over, named ``"data"`` as in the
# reference) or None.  They are the reference's tables: a rule gives the
# spec of a leaf's trailing dims, and leading dims pad with None.  The port
# holds a layer stack as a module list, so its leaves lack the reference's
# leading layer axis, and their specs lack its None.  A leaf with no rule
# raises, so a new parameter cannot fall back to replication unnoticed.
# Nothing in the port shards a model by them yet.

FSDP = "data"
MODEL = "model"
_REPLICATED = ()
_LM_RULES: dict[str, tuple] = {
    # embeddings / output head: vocab on model so CE logits stay distributed
    "embed": (MODEL, FSDP),
    "head": (FSDP, MODEL),
    # column-parallel projections (out dim on model, in dim FSDP-sharded)
    "wq": (FSDP, MODEL),
    "wk": (FSDP, MODEL),
    "wv": (FSDP, MODEL),
    "w_uq": (FSDP, MODEL),
    "w_uk": (FSDP, MODEL),
    "w_uv": (FSDP, MODEL),
    "w_dq": (FSDP, MODEL),
    "w_dkv": (FSDP, MODEL),
    "w_gate": (FSDP, MODEL),
    "w_up": (FSDP, MODEL),
    # row-parallel projections (in dim on model so the matmul reduces there)
    "wo": (MODEL, FSDP),
    "w_down": (MODEL, FSDP),
    # MoE expert stacks [E, in, out]: expert-parallel over model
    "we_gate": (MODEL, FSDP, None),
    "we_up": (MODEL, FSDP, None),
    "we_down": (MODEL, None, FSDP),
    # small / vector leaves
    "w_kr": (FSDP, None),
    "router": (FSDP, None),
    "router_bias": _REPLICATED,
    "proj": (FSDP, MODEL),
    "attn_norm": _REPLICATED,
    "ffn_norm": _REPLICATED,
    "final_norm": _REPLICATED,
    "q_norm": _REPLICATED,
    "kv_norm": _REPLICATED,
    "norm": _REPLICATED,
}


def _leaf_name(name: str) -> str:
    """The last component of a parameter name that is not a list index."""
    return next((p for p in reversed(name.split(".")) if not p.isdigit()), "")


def lm_param_specs(model: torch.nn.Module) -> dict:
    """Parameter name -> axis tuple for an LM (raises on a leaf with no rule)."""
    out = {}
    for name, p in model.named_parameters():
        leaf = _leaf_name(name)
        if leaf not in _LM_RULES:
            raise KeyError(f"no sharding rule for parameter leaf {leaf!r}")
        base = _LM_RULES[leaf]
        out[name] = (None,) * max(0, p.dim() - len(base)) + base
    return out


def gnn_param_specs(model: torch.nn.Module) -> dict:
    """GNN parameters are small MLPs: replicate, shard the graph data instead."""
    return {name: _REPLICATED for name, _ in model.named_parameters()}


def recsys_param_specs(model: torch.nn.Module) -> dict:
    """DeepFM: embedding-table vocab rows over model; MLPs replicated."""
    out = {}
    for name, p in model.named_parameters():
        if name.split(".")[0] in ("tables", "first_order") and p.dim() >= 2:
            spec = [None] * p.dim()
            spec[-2] = MODEL  # [F, V, D] -> the vocab axis
            out[name] = tuple(spec)
        else:
            out[name] = _REPLICATED
    return out
