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

Data-parallel training (``launch.mesh``'s ``("pod", "data", "model")``
mesh, ``launch.steps``) reads two more things here: ``dp_axes`` and
``dp_size``, the batch axes of a mesh (``("pod", "data")``, as the
reference's) and their ranks, and ``all_reduce_grads``, the gradient mean
over the batch axes: a leaf the data axis leaves whole is averaged over pod
x data, an FSDP leaf (already reduce-scattered over data) over pod alone,
summed bucket by bucket through ``PartitionMesh.all_reduce`` so each call
is counted.

The model axis and FSDP (``launch.mesh.make_mesh``'s ``(data = D, model
= T)`` mesh) read the rest:

  * the reference's rule tables (``lm_param_specs``, ``gnn_param_specs``,
    ``recsys_param_specs``: parameter name -> mesh-axis tuple), fitted to a
    mesh by ``fit_specs`` (the reference's ``_fit_specs``: an axis whose
    size does not divide its dimension is dropped);
  * ``place``: cuts each parameter of a module to the shard its fitted
    spec gives this rank (``shard_of``; ``gather_full`` puts it back
    together) and records the specs (``Placement``);
  * the autograd pairs the models call: ``copy_to_model`` (identity
    forward, all-reduce backward), ``reduce_from_model`` (all-reduce
    forward, identity backward), ``gather_from_model`` (all-gather
    forward, the rank's slice backward) and ``fsdp_gather`` (all-gather
    over ``data`` forward, reduce-scatter of the gradient backward), and
    ``weights``, which hands a layer its parameters gathered as it needs
    them;
  * ``PartitionMesh.reduce_scatter``, counted like the others (gloo runs
    it on CUDA tensors too).

The GNN steps (``launch.steps`` on the flattened axis ``HostMesh.flat``)
read the same pairs along dim 0: ``fsdp_gather`` (a node table's blocks
gathered, the gradient reduce-scattered), ``reduce_scatter_rows`` (partial
aggregates summed into the rank's block, the gradient all-gathered) and
``reduce_from_model`` (a readout's partial sums), with
``all_reduce_grads`` summing (not averaging) the partial gradients.
``gnn_param_specs`` replicates every parameter.

A collective over an axis of one rank is no call at all: it returns its
input (a copy where the call would give a new tensor) and counts nothing.
"""

from __future__ import annotations

import dataclasses
import time
import types
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
        """``MAX``, ``MIN`` or ``SUM`` over the ranks; returns a new tensor."""
        red = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM}[op]
        if self.world_size == 1:
            return t.clone()
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
        if self.world_size == 1:
            return t[None].clone()
        t0 = time.perf_counter()
        h = _wire(t)
        out = h.new_empty((self.world_size, *h.shape))
        dist.all_gather(list(out.unbind(0)), h, group=self.group)
        self.stats.add("all_gather", h.numel() * h.element_size(), time.perf_counter() - t0)
        return _unwire(out, t.dtype)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``[D, ...]`` on every rank -> ``[...]``: the sum over the ranks of
        their block ``rank`` (``reduce_scatter_tensor`` on flat views, the
        layout gloo takes)."""
        if t.shape[0] != self.world_size:
            raise ValueError(f"reduce_scatter wants [{self.world_size}, ...], got "
                             f"{tuple(t.shape)}")
        if self.world_size == 1:
            return t[0].clone()
        t0 = time.perf_counter()
        h = t.contiguous()
        out = h.new_empty(h.shape[1:])
        dist.reduce_scatter_tensor(out.view(-1), h.view(-1), group=self.group)
        self.stats.add("reduce_scatter", h.numel() * h.element_size(), time.perf_counter() - t0)
        return out

    def barrier(self) -> None:
        """Every rank waits here until all have arrived."""
        if self.world_size == 1:
            return
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

#: batch-like axes, in priority order (the reference's); FSDP lives on ``data``
_BATCH_AXES = ("pod", "data")

#: the most bytes one gradient all-reduce carries: ``all_reduce`` clones its
#: input, so a bucket costs twice its size on the device while it is summed
GRAD_BUCKET_BYTES = 256 << 20


def dp_axes(mesh) -> tuple[str, ...]:
    """The batch/data-parallel axes present in ``mesh`` (always a tuple)."""
    return tuple(a for a in _BATCH_AXES if a in mesh.axis_names)


def dp_size(mesh) -> int:
    """The ranks along ``mesh``'s batch axes (pod x data): how many shards
    a batch takes."""
    return mesh.batch.world_size


def all_reduce_grads(named_grads: dict, params: dict, mesh: PartitionMesh, *,
                     summed: frozenset = frozenset(), pod: PartitionMesh | None = None,
                     average: bool = True) -> dict:
    """The mean over the batch ranks of each rank's gradients (their sum,
    undivided, where ``average`` is False: the GNN steps' partial gradients
    over the flattened axis, whose sum is the one-rank gradient).

    ``mesh`` is the batch axes' ``PartitionMesh`` (``HostMesh.batch``: pod x
    data; the data axis where there is no pod axis).  ``named_grads`` maps
    each name of ``params`` (name -> parameter, in an order every rank
    shares) to its gradient, or None where autograd gave none on this rank:
    it counts as zeros, so every rank sends the same bytes.  The names in
    ``summed`` are leaves the data axis splits (FSDP): their gradients are
    already the data ranks' sum (``fsdp_gather``'s reduce-scatter); they are
    summed over ``pod`` (the pod ranks hold replicas of the same shard)
    where it has more than one rank, then divided by the batch rank count.
    The others' gradients are summed over ``mesh``.  Each sum lays the
    gradients of one dtype end to end and cuts them into buckets of at most
    ``GRAD_BUCKET_BYTES``, a tensor split across two where it straddles a
    cut; each bucket is summed by one ``all_reduce(op="sum")`` in that
    dtype, divided by the batch rank count and written back into the
    gradients, in place.  Returns name -> gradient, a zero tensor where the
    rank had None.
    """
    out = {}
    for name, p in params.items():
        g = named_grads.get(name)
        out[name] = torch.zeros_like(p) if g is None else g.contiguous()
    n_ranks = mesh.world_size if average else 1
    whole = {n: g for n, g in out.items() if n not in summed}
    split = {n: g for n, g in out.items() if n in summed}
    _mean_buckets(whole, mesh, n_ranks)
    if pod is not None and pod.world_size > 1:
        _mean_buckets(split, pod, n_ranks)
    else:
        for g in split.values():
            g.div_(n_ranks)
    return out


def _mean_buckets(grads: dict, axis: PartitionMesh, n_ranks: int) -> None:
    """``grads`` summed over ``axis`` bucket by bucket (see
    ``all_reduce_grads``) and divided by ``n_ranks``, in place."""
    by_dtype: dict = {}
    for g in grads.values():
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
                    _mean_bucket(pieces, axis, n_ranks)
                    pieces, n = [], 0
        if pieces:
            _mean_bucket(pieces, axis, n_ranks)


def _mean_bucket(pieces: list, axis: PartitionMesh, n_ranks: int) -> None:
    bucket = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    total = axis.all_reduce(bucket, op="sum")
    if n_ranks > 1:
        total.div_(n_ranks)
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
# ``fit_specs`` fits them to a mesh and ``place`` shards a module by them.

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


# ---------------------------------------------------------------------------
# fitting the specs to a mesh, and a rank's shards
# ---------------------------------------------------------------------------


def mesh_sizes(mesh) -> dict:
    """Axis name -> size, for a ``launch.mesh.HostMesh`` or ``MeshLayout``
    (its ``shape``) or any object with ``axis_names`` and ``devices.shape``
    (a JAX mesh, or a stand-in for one)."""
    if hasattr(mesh, "devices"):
        return dict(zip(mesh.axis_names, mesh.devices.shape))
    return dict(mesh.shape)


def axis_size(sizes: dict, ax) -> int:
    """The ranks along ``ax`` (an axis name, or a tuple of them as the
    reference's ``P(("pod", "data"))`` writes the batch axes); an axis the
    mesh lacks counts 1."""
    axes = ax if isinstance(ax, tuple) else (ax,)
    return int(np.prod([int(sizes.get(a, 1)) for a in axes]))


def fit_specs(specs: dict, model, mesh) -> dict:
    """The reference's ``_fit_specs``: each spec with the axes whose size
    does not divide their dimension dropped (None), padded with None to
    the leaf's rank.  ``model`` is a module or a dict name -> full shape.
    An entry may be a tuple of axes (their sizes multiply)."""
    sizes = mesh_sizes(mesh)
    shapes = (dict(model) if isinstance(model, dict)
              else {n: tuple(p.shape) for n, p in model.named_parameters()})
    out = {}
    for name, spec in specs.items():
        shape = shapes[name]
        fitted = []
        for dim, ax in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
            keep = ax is not None and shape[dim] % axis_size(sizes, ax) == 0
            fitted.append(ax if keep else None)
        out[name] = tuple(fitted)
    return out


def _axis(mesh, ax) -> PartitionMesh:
    """The ``PartitionMesh`` of ``ax``: ``"pod"``, ``"data"``, ``"model"``, or
    the batch axes as a tuple (``("pod", "data")``, or ``("data",)``)."""
    if isinstance(ax, tuple):
        if len(ax) == 1:
            return _axis(mesh, ax[0])
        if tuple(ax) != ("pod", "data"):
            raise ValueError(f"no mesh axis {ax!r}")
        return mesh.batch
    return {"pod": mesh.pod, "data": mesh.data, "model": mesh.model}[ax]


def shard_of(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view): along each
    dimension ``spec`` names an axis, the rank's index on that axis picks
    one of its size's equal slices."""
    t = full
    for dim, ax in enumerate(spec):
        if ax is not None:
            m = _axis(mesh, ax)
            t = t.tensor_split(m.world_size, dim=dim)[m.rank]
    return t


def gather_full(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``shard_of`` block (collective:
    every rank of the axes ``spec`` names calls it, in one order)."""
    t = local
    for dim, ax in enumerate(spec):
        if ax is not None:
            t = _cat_gathered(_axis(mesh, ax).all_gather(t), dim)
    return t


def _cat_gathered(every: torch.Tensor, dim: int) -> torch.Tensor:
    """``[D, ...]`` from ``all_gather`` -> the D blocks laid end to end
    along ``dim``."""
    return torch.cat(list(every.unbind(0)), dim=dim)


def _blocks(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``t`` cut into ``n`` equal blocks along ``dim``, stacked: ``[n, ...]``."""
    return torch.stack(t.tensor_split(n, dim=dim))


# ---------------------------------------------------------------------------
# the autograd pairs of the model axis and FSDP
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.contiguous(), op="sum"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x, op="sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    """All-gather along ``dim`` forward.  Backward, the rank's block of the
    gradient: sliced from one every rank holds whole (replicated work
    downstream), or, with ``scatter``, reduce-scattered from the parts each
    rank holds (its own rows' work on a gathered FSDP weight)."""

    @staticmethod
    def forward(ctx, x, axis, dim, scatter):
        ctx.axis, ctx.dim, ctx.scatter = axis, dim, scatter
        return _cat_gathered(axis.all_gather(x.contiguous()), dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        if ctx.scatter:
            out = axis.reduce_scatter(_blocks(g, axis.world_size, dim))
        else:
            out = g.tensor_split(axis.world_size, dim=dim)[axis.rank].contiguous()
        return out, None, None, None


class _ScatterAlong(torch.autograd.Function):
    """Reduce-scatter along dim 0 forward: the ranks' partials summed, the
    rank's block of rows kept.  Backward, the blocks' gradients
    all-gathered: each rank's partial fed every block."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.reduce_scatter(x.reshape(axis.world_size, -1, *x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        return _cat_gathered(ctx.axis.all_gather(g.contiguous()), 0), None


# Outside grad mode (the serving steps run under ``torch.inference_mode``)
# each pair is its forward collective alone: no autograd node is made.


def copy_to_model(x: torch.Tensor, axis: PartitionMesh | None) -> torch.Tensor:
    """A replicated tensor entering model-split work: identity forward, the
    gradient summed over the model axis backward (each rank's part)."""
    if axis is None or axis.world_size == 1 or not torch.is_grad_enabled():
        return x
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: PartitionMesh | None) -> torch.Tensor:
    """Model-split partial sums leaving to replicated work: summed over the
    model axis forward, the (replicated) gradient passed through backward."""
    if axis is None or axis.world_size == 1:
        return x
    if not torch.is_grad_enabled():
        return axis.all_reduce(x, op="sum")
    return _ReduceFromModel.apply(x, axis)


def _gather_along(x: torch.Tensor, axis: PartitionMesh, dim: int, scatter: bool):
    if not torch.is_grad_enabled():
        return _cat_gathered(axis.all_gather(x.contiguous()), dim)
    return _GatherAlong.apply(x, axis, dim, scatter)


def gather_from_model(x: torch.Tensor, axis: PartitionMesh | None,
                      dim: int = -1) -> torch.Tensor:
    """The model ranks' blocks of ``x`` laid end to end along ``dim``; the
    gradient (replicated work downstream) gives back the rank's block."""
    if axis is None or axis.world_size == 1:
        return x
    return _gather_along(x, axis, dim % x.dim(), False)


def reduce_scatter_rows(x: torch.Tensor, axis: PartitionMesh | None) -> torch.Tensor:
    """The rank's block of rows of the ranks' summed partials ``x`` (``[R *
    n, ...]``: reduce-scatter forward); the block's gradient all-gathered
    backward.  Every rank must pass the same shape."""
    if axis is None or axis.world_size == 1:
        return x
    if not torch.is_grad_enabled():
        return axis.reduce_scatter(x.reshape(axis.world_size, -1, *x.shape[1:]))
    return _ScatterAlong.apply(x, axis)


def fsdp_gather(w: torch.Tensor, axis: PartitionMesh | None, dim: int) -> torch.Tensor:
    """A parameter's FSDP shards gathered over the data axis along ``dim``;
    backward, the gradient reduce-scattered to the shards (the ranks'
    sum: ``all_reduce_grads`` divides it by the rank count)."""
    if axis is None or axis.world_size == 1:
        return w
    return _gather_along(w, axis, dim, True)


# ---------------------------------------------------------------------------
# a placed module
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Placement:
    """How a module's parameters lie on a mesh: the mesh and each
    parameter's fitted spec by name (``place`` sets it as the module's
    ``placement``)."""

    mesh: Any
    specs: dict

    def split_axes(self, name: str) -> tuple:
        """The axes of more than one rank that split parameter ``name``."""
        sizes = self.mesh.shape
        return tuple(a for a in ("data", "model")
                     if a in self.specs[name] and sizes[a] > 1)

    def data_split(self) -> frozenset:
        """The names of the parameters the data axis splits."""
        return frozenset(n for n in self.specs if "data" in self.split_axes(n))

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The float32 norm of the whole gradient: each leaf's local squares
        summed with the leaves the same axes split, and each sum all-reduced
        over those axes (a replicated leaf counts once).  One all-reduce over
        ``data`` where it splits a leaf, then one over ``model`` where it
        does."""
        dev = next(iter(grads.values())).device
        sums = {k: torch.zeros((), dtype=torch.float32, device=dev)
                for k in ((), ("data",), ("model",), ("data", "model"))}
        for name in self.specs:
            g = grads.get(name)
            if g is not None:
                key = self.split_axes(name)
                sums[key] = sums[key] + torch.sum(torch.square(g.to(torch.float32)))
        split = {a for n in self.specs for a in self.split_axes(n)}
        d = torch.stack([sums[("data", "model")], sums[("data",)]])
        if "data" in split:
            d = self.mesh.data.all_reduce(d, op="sum")
        m = torch.stack([d[0], sums[("model",)]])
        if "model" in split:
            m = self.mesh.model.all_reduce(m, op="sum")
        return torch.sqrt(sums[()] + d[1] + m[1] + m[0])


def place(module: torch.nn.Module, specs: dict, mesh) -> torch.nn.Module:
    """Shard ``module`` in place: each parameter becomes this rank's block
    of itself under ``specs[name]`` fitted to ``mesh`` (``fit_specs``), a
    tensor of its own; every submodule learns its own parameters' specs
    (``_shard_specs``, read by ``weights``) and the module its
    ``placement``.  Returns it."""
    missing = sorted(set(n for n, _ in module.named_parameters()) - set(specs))
    if missing:
        raise KeyError(f"no spec for {missing}")
    specs = fit_specs(specs, module, mesh)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.data = shard_of(p.data, specs[name], mesh).clone(
                memory_format=torch.contiguous_format)
    for prefix, sub in module.named_modules():
        sub._shard_specs = {
            n: specs[f"{prefix}.{n}" if prefix else n]
            for n, _ in sub.named_parameters(recurse=False)}
    module.placement = Placement(mesh, dict(specs))
    return module


def placement_of(module: torch.nn.Module) -> Placement | None:
    """The module's ``Placement``, or None where ``place`` never ran."""
    return getattr(module, "placement", None)


def model_split(module: torch.nn.Module, names, mesh) -> bool:
    """Whether the model axis (of more than one rank) splits every one of
    ``module``'s parameters ``names``: the layer then runs its
    tensor-parallel path on its own blocks."""
    specs = getattr(module, "_shard_specs", None)
    if mesh is None or specs is None or mesh.model.world_size == 1:
        return False
    return all(MODEL in specs[n] for n in names)


def gathered_matmul(x: torch.Tensor, w: torch.Tensor, axis: PartitionMesh | None):
    """``x @ w`` whole, where ``axis`` (the model axis, or None) splits
    ``w``'s columns: each rank's block of the product, gathered."""
    if axis is None or axis.world_size == 1:
        return x @ w
    return gather_from_model(copy_to_model(x, axis) @ w, axis)


def weights(module: torch.nn.Module, mesh, names, *, local: bool):
    """``module``'s parameters ``names`` as the layer computes with them (a
    namespace, attribute per name): FSDP shards gathered over the data axis
    (``fsdp_gather``), and the model axis's blocks kept (``local``, the
    tensor-parallel path) or gathered too (``gather_from_model``, the
    replicated path).  Without a placement, the parameters themselves."""
    specs = getattr(module, "_shard_specs", None)
    out = types.SimpleNamespace()
    for n in names:
        w = getattr(module, n)
        if mesh is not None and specs is not None:
            for dim, ax in enumerate(specs[n]):
                if ax == FSDP:
                    w = fsdp_gather(w, mesh.data, dim)
                elif ax == MODEL and not local:
                    w = gather_from_model(w, mesh.model, dim)
        setattr(out, n, w)
    return out
