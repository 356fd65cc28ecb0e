"""Layer 1: the window auditor (the port of ``repro.analysis.jaxpr_audit``).

The JAX package traces a window into one jaxpr and walks it.  The port has
no jaxpr: a window is a host loop that enqueues launches.  So the auditor
*runs* one window and records its op log -- every aten op that the window
dispatches, under a ``TorchDispatchMode`` (``OpLog``), with its devices and
argument shapes -- and, on a mesh, each rank's ordered log of the
collectives that actually reach its ``PartitionMesh`` (``RecordingMesh``).
Nothing in the engine is edited for it: the audit wraps the mesh, swaps two
module-level helpers for counting wrappers for the window's length, and
builds engines the way a caller does.  The checks:

  JX01  the host reads (``aten._local_scalar_dense``) and device-to-host
        transfers of a window are exactly what the engine counted:
        reads = the change in ``host_syncs`` less the change in
        ``bulk_pulls``, transfers = ``TRANSFERS_PER_PULL`` x the change in
        ``bulk_pulls``.  On the CPU, ``.cpu()``/``.numpy()`` of a CPU tensor
        dispatch nothing, so transfers are counted at the counted helper
        (``traversal._to_host``); on a card, as the window's device-to-host
        copies (and each helper call must be one).  A data-dependent-shape
        op (``nonzero``, ``unique``, boolean-mask ``index``, ...) on the hot
        path is a finding of its own.
  JX02  on a mesh: every rank's ordered collective log is the same (a
        rank-conditional collective deadlocks the others); each superstep's
        collectives are what ``validate_collective_signature(program,
        mirrored=...)`` declares, and the program's own tally
        (``last_window_collectives``) agrees with what reached the mesh; the
        window ends in its declared epilogue; every host read in a mesh
        window reads a value computed from ``all_reduce`` results only (a
        loop condition on a rank-local value lets iteration counts diverge).
  JX03  every launch grid passes ``kernels.build.check_grid``
        (``grid_findings``), and one ran before every launch of each
        kernel; backend ``"cuda"`` launches the relax and the
        partition-counter kernels, ``"torch"`` neither; a layout's
        ``row_ptr`` is split once, not again in a later window.  AL03's
        intent -- a kernel writes every
        output element -- is ``check_poisoned_output``: each kernel wrapper
        launched into poisoned memory must still equal its plain version.
  JX04  host numpy over ``structs.mesh_layout_key`` and the layout caches:
        the key is canonical (``check_cache_key_fn``), a placement sweep
        with revisits builds each layout once and fits the caches
        (``audit_recompile_budget``; on the ranks, by the rank-layout builds
        of a relayout sweep over window lengths), and a
        mutate->merge->mutate cycle mints fresh keys, primes the cache and
        equals a from-scratch build (``audit_delta_cycle``).
  JX05  the program's ``identity`` is the dtype-derived identity of its
        ``reduce`` and a fixed point of ``relax``/``combine``.

Every check returns ``Finding`` lists; ``audit_tree`` runs the whole matrix.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import (
    AUDIT_BACKENDS,
    AUDIT_MESH_WIDTH,
    AUDIT_MIRROR_DEGREE,
    TRANSFERS_PER_PULL,
)
from repro_torch.dist.sharding import PartitionMesh
from repro_torch.graph import partition as partition_module
from repro_torch.graph import traversal as traversal_module
from repro_torch.graph.config import EngineConfig, resolve_device
from repro_torch.graph.partition import (
    _LAYOUT_CACHE_MAX,
    _RANK_LAYOUT_CACHE_MAX,
    contiguous_device_map,
    mesh_edge_layout,
)
from repro_torch.graph.program import (
    BUILTIN_PROGRAMS,
    BfsProgram,
    SsspProgram,
    validate_collective_signature,
    validate_program,
)
from repro_torch.graph.structs import Graph, PartitionedGraph, mesh_layout_key
from repro_torch.kernels import build as build_module
from repro_torch.kernels.bfs_relax import kernel as relax_module
from repro_torch.kernels.bfs_relax.ops import _identity_scalar, relax_blockmap_call
from repro_torch.kernels.bfs_relax.ref import relax_reference
from repro_torch.kernels.flash_attention import kernel as flash_module
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.kernels.part_count import kernel as part_count_module
from repro_torch.kernels.segment_sum import kernel as segment_module
from repro_torch.kernels.segment_sum.ops import sorted_segment_sum
from repro_torch.kernels.segment_sum.ref import reference_segment_sum

#: the sources every audited window starts from (batch rows for WCC/PageRank)
AUDIT_SOURCES = (0, 7, 33)

#: supersteps each chained window of the audit may run: the first stops at
#: its bound mid-traversal, so the later one has supersteps left to run (on
#: the audit graph BFS, SSSP and WCC converge within it, PageRank runs it
#: to its bound)
AUDIT_WINDOWS = (1, 4)

#: how long the mesh audit's one launch of ranks may take
MESH_AUDIT_TIMEOUT_S = 600.0

#: the collectives every mesh window ends with, after its superstep loop:
#: one ``all_reduce(SUM)`` of every counter and the partition activity
MESH_WINDOW_EPILOGUE = {"all_reduce:sum": 1}

#: the placement rotations and window lengths of the relayout sweep (each
#: placement revisited, each length revisited)
SWEEP_ROTATIONS = (0, 1, 0, 1)
SWEEP_WINDOWS = (1, 4, 8, 4, 1)

#: aten ops whose output shape depends on tensor values
_DATA_DEPENDENT_OPS = {
    "nonzero", "_unique", "_unique2", "unique_dim", "unique_consecutive",
    "masked_select", "argwhere",
}


# -- the op log ---------------------------------------------------------------


class OpLog(TorchDispatchMode):
    """Every aten op dispatched while active, as ``(name, devices, arg
    shapes)`` in ``records``, plus what the checks read off it: host reads
    (``_local_scalar_dense``), device-to-host transfers, data-dependent-shape
    ops, and ``events`` -- host reads and (from a ``RecordingMesh``)
    collectives in one ordered stream.

    A tensor is *synced* when it was computed from constants and
    ``all_reduce`` results only -- the same value on every rank; each read
    event says whether the value it read was.
    """

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the log never runs under torch.compile: left wrapped in
        # ``torch._disable_dynamo``, its first op imports torch._dynamo and
        # sympy (seconds, in every mesh rank) for nothing
        return False

    def __init__(self):
        super().__init__()
        self.records: list[tuple] = []
        self.events: list[tuple] = []
        self.reads = 0
        self.d2h = 0
        self.data_dependent: list[str] = []
        self._synced = WeakTensorKeyDictionary()

    def mark_synced(self, t: torch.Tensor) -> None:
        self._synced[t] = True

    def is_synced(self, t: torch.Tensor) -> bool:
        return t in self._synced

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket.__name__
        tensors_in = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        self.records.append((
            str(func),
            tuple(sorted({str(t.device) for t in tensors_in})),
            tuple(tuple(t.shape) for t in tensors_in),
        ))
        if packet == "_local_scalar_dense":
            self.reads += 1
            self.events.append(("read", self.is_synced(args[0]), out))
        elif packet == "_to_copy" and args[0].device.type != "cpu" and out.device.type == "cpu":
            self.d2h += 1
        elif packet == "copy_" and args[0].device.type == "cpu" and args[1].device.type != "cpu":
            self.d2h += 1
        if _is_data_dependent(packet, args, kwargs):
            self.data_dependent.append(str(func))
        synced = packet == "allreduce_" or all(self.is_synced(t) for t in tensors_in)
        for t in tree_flatten(out)[0] + (tensors_in if packet == "allreduce_" else []):
            if isinstance(t, torch.Tensor):
                if synced:
                    self._synced[t] = True
                elif t in self._synced:
                    del self._synced[t]
        return out


def _is_data_dependent(packet: str, args, kwargs) -> bool:
    if packet in _DATA_DEPENDENT_OPS:
        return True
    if packet == "repeat_interleave":
        return kwargs.get("output_size") is None
    if packet in ("index", "index_put", "index_put_"):
        return any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
            for i in args[1]
        )
    return False


# -- the recording mesh -------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class RecordingMesh(PartitionMesh):
    """A ``PartitionMesh`` that records, in call order, every collective that
    reaches it: ``calls`` holds ``(op, reduce op, dtype, shape)`` for the
    mesh's life; while ``tap["log"]`` holds an ``OpLog``, each call also
    enters its ordered ``events`` and an ``all_reduce`` result is marked
    synced there."""

    calls: list = dataclasses.field(default_factory=list)
    tap: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def wrap(cls, mesh: PartitionMesh) -> "RecordingMesh":
        return cls(**{f.name: getattr(mesh, f.name) for f in dataclasses.fields(PartitionMesh)})

    def _recorded(self, op: str, t: torch.Tensor, arg, run):
        out = run()
        shape = t.dim() if op == "all_to_all_v" else tuple(t.shape)  # uneven splits
        entry = (f"{op}:{arg}" if arg else op, str(t.dtype), shape)
        self.calls.append(entry)
        log = self.tap.get("log")
        if log is not None:
            log.events.append(("collective", *entry))
            if op == "all_reduce":
                log.mark_synced(out)
        return out

    def all_reduce(self, t, op="max"):
        return self._recorded("all_reduce", t, op, lambda: PartitionMesh.all_reduce(self, t, op))

    def all_to_all(self, t):
        return self._recorded("all_to_all", t, None, lambda: PartitionMesh.all_to_all(self, t))

    def all_to_all_v(self, t, send_counts, recv_counts):
        return self._recorded(
            "all_to_all_v", t, None,
            lambda: PartitionMesh.all_to_all_v(self, t, send_counts, recv_counts),
        )

    def all_gather(self, t):
        return self._recorded("all_gather", t, None, lambda: PartitionMesh.all_gather(self, t))


@dataclasses.dataclass(frozen=True, eq=False)
class SimulatedMesh(RecordingMesh):
    """One rank of a mesh simulated in one process: each collective is
    recorded and returns this rank's own values (as if every rank held the
    same), so a window shaped like the mesh window runs per simulated rank
    without starting ranks that could deadlock."""

    def all_reduce(self, t, op="max"):
        return self._recorded("all_reduce", t, op, t.clone)

    def all_to_all(self, t):
        return self._recorded("all_to_all", t, None, t.clone)


def simulated_mesh(world_size: int, rank: int) -> SimulatedMesh:
    return SimulatedMesh(int(world_size), int(rank), torch.device("cpu"), None)


# -- patching helpers ---------------------------------------------------------


@contextlib.contextmanager
def _recording_calls(module, name: str):
    """Swap ``module.name`` for a wrapper that records each call's
    positional arguments, for the block's length."""
    calls = []
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(args)
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


#: the launch wrappers' modules, each calling ``check_grid`` before its launches
_WRAPPER_MODULES = {
    "relax": relax_module, "segment_sum": segment_module, "flash": flash_module,
    "part_count": part_count_module,
}


@contextlib.contextmanager
def _recording_grids():
    """Record every ``check_grid`` call of the four launch wrappers, by
    wrapper."""
    with contextlib.ExitStack() as stack:
        yield {
            name: stack.enter_context(_recording_calls(module, "check_grid"))
            for name, module in _WRAPPER_MODULES.items()
        }


# -- JX01: host traffic -------------------------------------------------------


def check_host_traffic(
    log: OpLog, label: str, *, reads_counted: int, pulls_counted: int, transfers: int,
    transfers_per_pull: int = TRANSFERS_PER_PULL,
) -> list[Finding]:
    """A window's host reads and transfers against what its engine counted."""
    findings = []
    if log.reads > reads_counted:
        findings.append(Finding(
            "JX01", label,
            f"{log.reads - reads_counted} uncounted host read(s): the window read "
            f"{log.reads} device value(s) to the host, the engine counted "
            f"{reads_counted} -- each stalls the card between two launches",
        ))
    elif log.reads < reads_counted:
        findings.append(Finding(
            "JX01", label,
            f"the engine counted {reads_counted} host reads, the window made "
            f"{log.reads}: a counter counts reads that never happened",
        ))
    if transfers != transfers_per_pull * pulls_counted:
        findings.append(Finding(
            "JX01", label,
            f"{transfers} device-to-host transfer(s) for {pulls_counted} counted "
            f"bulk pull(s); the relation is {transfers_per_pull} a pull",
        ))
    for name, n in sorted(Counter(log.data_dependent).items()):
        findings.append(Finding(
            "JX01", label,
            f"data-dependent-shape op '{name}' on the hot path ({n}x): its "
            "output size is an uncounted host read",
        ))
    return findings


def audit_window(engine, state, k: int, label: str, *, first: bool = True):
    """Run ``engine.run_window(state, k)`` under the op log; returns
    ``(findings, stats, result)``: JX01 against the engine's counters, JX03
    on the launches and grids (``first``: the engine's first window, the
    only one that may split a ``row_ptr``), and, on a mesh, the ordered
    ``events``."""
    mesh = getattr(engine._mesh_prog, "mesh", None)
    syncs0, pulls0 = engine.host_syncs, engine.bulk_pulls
    kern = relax_module.relax_rowptr
    counter = part_count_module.part_count
    launches0, parts0, counts0 = kern.launches, kern.partition_launches, counter.launches
    log = OpLog()
    with contextlib.ExitStack() as stack:
        helper = stack.enter_context(_recording_calls(traversal_module, "_to_host"))
        grids = stack.enter_context(_recording_grids())
        if isinstance(mesh, RecordingMesh):
            mesh.tap["log"] = log
            stack.callback(mesh.tap.pop, "log", None)
        with log:
            result = engine.run_window(state, k)
    pulls = engine.bulk_pulls - pulls0
    on_card = engine.device.type == "cuda"
    transfers = log.d2h if on_card else len(helper)
    findings = check_host_traffic(
        log, label, reads_counted=engine.host_syncs - syncs0 - pulls,
        pulls_counted=pulls, transfers=transfers,
    )
    if on_card and log.d2h != len(helper):
        findings.append(Finding(
            "JX01", label,
            f"{log.d2h} device-to-host copies but {len(helper)} counted pull "
            "transfers: a copy bypassed the counted helper",
        ))
    launches = kern.launches - launches0
    count_launches = counter.launches - counts0
    for name, n in (("relax", launches), ("part_count", count_launches)):
        if n > len(grids[name]):
            findings.append(Finding(
                "JX03", label, f"{n} {name} launch(es) but {len(grids[name])} grid "
                "check(s): a launch ran without check_grid",
            ))
    # a window launches the kernel unless it has no edge to relax (a mesh
    # plane with no valid edge on this rank launches nothing) or it began
    # after the traversal had converged (it runs no superstep)
    if engine._mesh_prog is not None:
        has_edges = any(p is not None and p.n_valid for p in engine._mesh_prog._consts[:3])
    else:
        has_edges = engine.pg.graph.n_edges > 0
    inner_iters = int(np.asarray(result.inner_iters).sum())
    converged = inner_iters == 0 and bool(np.asarray(result.done).all())
    stats = {
        "reads": log.reads, "transfers": transfers, "pulls": pulls,
        "ops": len(log.records), "inner_iters": inner_iters, "launches": launches,
        "partition_launches": kern.partition_launches - parts0,
        "part_count_launches": count_launches,
        "grid_checks": sum(map(len, grids.values())), "events": log.events,
        "transfers_per_pull": transfers / pulls if pulls else None,
    }
    findings += _launch_findings(engine.backend, stats, label, first, has_edges and not converged)
    return findings, stats, result


def synchronizing_calls(fn):
    """``(fn(), n)``: ``n`` counts the synchronizing CUDA calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports while ``fn`` runs
    (the card's own count of what JX01 counts from the op log)."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    n = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
    return out, n


# -- JX03: launch grids and launches -------------------------------------------


def grid_findings(grids, label: str) -> list[Finding]:
    """Each grid through ``kernels.build.check_grid``: a dimension < 1 is a
    launch that never runs the kernel, whose output is never written."""
    findings = []
    for grid in grids:
        try:
            build_module.check_grid(tuple(grid), label)
        except ValueError as exc:
            findings.append(Finding(
                "JX03", label,
                f"launch grid dimension < 1: {exc}; the kernel never runs and "
                "its output is never written",
            ))
    return findings


def _launch_findings(
    backend: str, stats: dict, label: str, first: bool, expect: bool = True
) -> list[Finding]:
    findings = []
    if backend == "cuda" and expect and stats["launches"] == 0:
        findings.append(Finding(
            "JX03", label,
            "backend 'cuda' selected but the window launched the relax kernel "
            "no time -- it silently ran the plain version",
        ))
    if backend == "torch" and stats["launches"]:
        findings.append(Finding(
            "JX03", label, f"backend 'torch' launched the CUDA relax kernel "
            f"{stats['launches']} time(s)",
        ))
    # every window counts its partition activity at its end, so a window on
    # the kernel launches the counters' kernel at least once
    if backend == "cuda" and stats["part_count_launches"] == 0:
        findings.append(Finding(
            "JX03", label,
            "backend 'cuda' selected but the window launched the partition-counter "
            "kernel no time -- it silently ran the plain version",
        ))
    if backend == "torch" and stats["part_count_launches"]:
        findings.append(Finding(
            "JX03", label, f"backend 'torch' launched the CUDA partition-counter kernel "
            f"{stats['part_count_launches']} time(s)",
        ))
    if not first and stats["partition_launches"]:
        findings.append(Finding(
            "JX03", label,
            f"a later window split {stats['partition_launches']} row_ptr(s) again: "
            "the kernel's tile starts must be kept while the layout lives",
        ))
    return findings


# -- AL03's intent: launches into poisoned memory -----------------------------


def _free_blocks(device: torch.device) -> list[int]:
    stream = torch.cuda.current_stream(device).cuda_stream
    return [
        b["size"]
        for seg in torch.cuda.memory_snapshot()
        if seg["device"] == device.index and seg.get("stream", stream) == stream
        for b in seg["blocks"]
        if b["state"] == "inactive"
    ]


@contextlib.contextmanager
def poisoned_memory(device, reserve_bytes: int = 0):
    """Uninitialized memory on ``device`` holds poison for the block.

    On a card, the caching allocator's free blocks are filled with 0xFF
    bytes (NaN as float32 or bfloat16, -1 as int32) by allocating each,
    filling it and freeing it, after ``reserve_bytes`` more are cached; the
    allocator hands the same blocks, in the same order, to the
    allocations that follow.  On the CPU, which keeps no free blocks,
    torch's deterministic mode fills each new tensor (NaN, an integer
    type's maximum) instead.  Yields the poisoned byte count (-1 on the
    CPU)."""
    device = resolve_device(device)
    if device.type != "cuda":
        mode = torch.are_deterministic_algorithms_enabled()
        warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
        fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = True
        try:
            yield -1
        finally:
            torch.utils.deterministic.fill_uninitialized_memory = fill
            torch.use_deterministic_algorithms(mode, warn_only=warn_only)
        return
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    # cache free memory in both pools: a block of at most 1 MiB (the small
    # pool's) and ``reserve_bytes`` (the large pool's)
    for nbytes in (1 << 20, int(reserve_bytes)):
        if nbytes:
            del_me = torch.empty(nbytes, dtype=torch.uint8, device=device)
            del del_me
    held = []
    for _ in range(64):
        sizes = _free_blocks(device)
        if not sizes:
            break
        held += [torch.empty(s, dtype=torch.uint8, device=device) for s in sorted(sizes, reverse=True)]
    for t in held:
        t.fill_(0xFF)
    torch.cuda.synchronize(device)
    poisoned = sum(t.numel() for t in held)
    del held
    yield poisoned


def check_poisoned_output(
    label: str, launch, agree, *, device, out_nbytes: int, reserve_bytes: int = 0
) -> tuple[list[Finding], dict]:
    """``launch()`` -- one call of a kernel wrapper -- into poisoned memory:
    ``agree(out)`` must hold (the output equals its plain version at the
    bound the caller names).  A kernel that skips an output element returns
    poison there.  On a card the check first proves that the poison
    reaches a block of the output's size.  Returns ``(findings, stats)``."""
    findings = []
    with poisoned_memory(device, reserve_bytes) as poisoned:
        probe = torch.empty(int(out_nbytes), dtype=torch.uint8, device=device)
        landed = bool((probe == 0xFF).all())
        del probe
        out = launch()
    ok, err = agree(out)
    if not landed:
        findings.append(Finding(
            "AL03", label,
            "the poison did not reach a block of the output's size: the check "
            "cannot see an unwritten element",
        ))
    if not ok:
        findings.append(Finding(
            "AL03", label,
            f"output differs from its plain version under poisoned memory "
            f"(error {err}): the kernel leaves output elements unwritten",
        ))
    return findings, {"poisoned_bytes": poisoned, "landed": landed, "err": err}


def _relax_case(gen, device, s, n, e, dtype):
    """Random dst-sorted edges over ``n`` rows, some rows with none."""
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
    dst[dst % 7 == 3] = 0  # rows 3 mod 7 get no edge (their output is base)
    dst = torch.sort(dst).values
    row_ptr = torch.searchsorted(dst, torch.arange(n + 1)).to(torch.int32)
    if dtype == torch.float32:
        cand = torch.rand((s, e), generator=gen) * 10
        base = torch.rand((s, n), generator=gen) * 10
    else:
        cand = torch.randint(0, 1000, (s, e), generator=gen, dtype=torch.int32)
        base = torch.randint(0, 1000, (s, n), generator=gen, dtype=torch.int32)
    return (row_ptr.to(device), dst.to(device), cand.to(device), base.to(device))


def poison_cases(device, seed: int = 0) -> list[tuple]:
    """``(label, launch, agree, out_nbytes)`` for each kernel wrapper, at
    shapes its callers give it: relax over rows with and without edges (the
    three instantiations the main path runs), the segment sum at D = 1 and
    75 over several levels with empty segments and dropped ids, flash in
    bfloat16 at a ragged S with d = 128 and 64."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    cases = []
    for dtype, reduce in ((torch.float32, "min"), (torch.int32, "min"), (torch.float32, "sum")):
        row_ptr, dst, cand, base = _relax_case(gen, device, 4, 5000, 40000, dtype)
        plain = relax_reference(dst.to(torch.int64), cand, base, reduce)

        def launch(row_ptr=row_ptr, dst=dst, cand=cand, base=base, reduce=reduce):
            return relax_blockmap_call(
                row_ptr, dst.to(torch.int64), cand, base, reduce=reduce, backend=_backend(base)
            )

        def agree(out, plain=plain, reduce=reduce):
            if reduce == "min":
                return torch.equal(out, plain), float((out != plain).sum())
            diff, ref = (out.double() - plain.double()).abs(), plain.double()
            return bool((diff <= 1e-9 + 1e-5 * ref.abs()).all()), float(diff.max())

        name = f"{str(dtype).removeprefix('torch.')}-{reduce}"
        cases.append((f"poison/relax/{name}", launch, agree, base.numel() * base.element_size()))
    for e, n, d in ((300_000, 50_000, 1), (60_000, 9_000, 75)):
        ids = torch.sort(torch.randint(-5, n + 5, (e,), generator=gen)).values.to(device)
        ids[(ids % 5) == 2] = -1  # segments 2 mod 5 stay empty; -1 is dropped
        ids = torch.sort(ids).values
        vals = torch.randn((e, d), generator=gen).to(device)
        ref = reference_segment_sum(ids, vals.double(), n)
        scale = reference_segment_sum(ids, vals.double().abs(), n).sum(dim=1, keepdim=True)

        def launch(ids=ids, vals=vals, n=n):
            return sorted_segment_sum(ids, vals, n, assume_sorted=True, backend=_backend(vals))

        def agree(out, ref=ref, scale=scale):
            diff = (out.double() - ref).abs()
            return bool((diff <= 1e-6 * scale).all()), float(diff.max())

        cases.append((f"poison/segment_sum/D{d}", launch, agree, n * d * 4))
    for s, h, hk, d, window in ((1000, 8, 2, 128, 256), (777, 4, 4, 64, None)):
        q, k, v = (
            torch.randn((1, s, heads, d), generator=gen).to(torch.bfloat16).to(device)
            for heads in (h, hk, hk)
        )
        ref = reference_attention(q.float(), k.float(), v.float(), causal=True, window=window)

        def launch(q=q, k=k, v=v, window=window):
            with torch.no_grad():
                return flash_attention(q, k, v, causal=True, window=window, backend=_backend(q))

        def agree(out, ref=ref):
            err = (out.float() - ref).abs().max()
            return bool(err <= 2e-2), float(err)

        cases.append((f"poison/flash/d{d}", launch, agree, q.numel() * q.element_size()))
    return cases


def _backend(t: torch.Tensor) -> str:
    return "cuda" if t.device.type == "cuda" else "torch"


def audit_poisoned_kernels(device, seed: int = 0) -> tuple[list[Finding], list[dict]]:
    """``check_poisoned_output`` over ``poison_cases``: on a card the three
    CUDA wrappers, on the CPU their plain versions (which allocate their
    outputs by operations that write them)."""
    findings, rows = [], []
    for label, launch, agree, nbytes in poison_cases(device, seed):
        f, stats = check_poisoned_output(
            label, launch, agree, device=device, out_nbytes=nbytes, reserve_bytes=64 << 20
        )
        findings += f
        rows.append({"case": label, **stats})
    return findings, rows


# -- JX02: collective balance -------------------------------------------------


def _is_a2a(ev) -> bool:
    return ev[0] == "collective" and ev[1] == "all_to_all"


def split_supersteps(events: list) -> tuple[list[list], list]:
    """A mesh window's ordered events cut after each run of exchange
    ``all_to_all``s (a superstep ends with its exchange): ``(supersteps,
    tail)``, the tail being what follows the last exchange."""
    steps, cur = [], []
    for i, ev in enumerate(events):
        cur.append(ev)
        if _is_a2a(ev) and (i + 1 == len(events) or not _is_a2a(events[i + 1])):
            steps.append(cur)
            cur = []
    return steps, cur


def _kinds(events) -> Counter:
    return Counter(ev[1] for ev in events if ev[0] == "collective")


def check_window_collectives(
    events: list, signature: dict, label: str, *, m_max: int, record: list | None = None,
) -> list[Finding]:
    """Check one rank's window against a declared signature.

    ``events`` is the window's ordered stream (``OpLog.events``);
    ``signature`` the per-superstep declaration
    (``validate_collective_signature``), and ``MESH_WINDOW_EPILOGUE`` the
    window-level one; ``record`` the program's own per-superstep tally,
    when there is one.
    A superstep is its condition (an ``all_reduce(max)`` read on the host),
    ``pmax_boundary`` syncs, ``pmax_closure`` syncs per closure iteration
    (each iteration ends in one host read, its loop condition), ``psum``
    value sums and ``all_to_all`` exchanges, which end it.  Reused verbatim
    by the fixture corpus, so the checker that gates the audit is the
    checker the fixtures prove can fire.
    """
    findings = []
    for i, ev in enumerate(e for e in events if e[0] == "read"):
        if not ev[1]:
            findings.append(Finding(
                "JX02", label,
                f"host read {i} of the window (a loop condition) reads a value no "
                "all_reduce produced: the condition is device-local and iteration "
                "counts can diverge across ranks",
            ))
    steps, tail = split_supersteps(events)
    for s, step in enumerate(steps):
        kinds = _kinds(step)
        reads = sum(ev[0] == "read" for ev in step)
        iters = max(reads - 1, 0)  # the first read is the superstep condition
        got = {
            "all_to_all": kinds["all_to_all"], "psum": kinds["all_reduce:sum"],
            "pmax": kinds["all_reduce:max"],
        }
        want = {
            "all_to_all": signature["all_to_all"], "psum": signature["psum"],
            "pmax": 1 + signature["pmax_boundary"] + signature["pmax_closure"] * iters,
        }
        other = {k: v for k, v in kinds.items()
                 if k not in ("all_to_all", "all_reduce:sum", "all_reduce:max")}
        if got != want or other or reads < 1:
            findings.append(Finding(
                "JX02", label,
                f"superstep {s}: superstep-boundary collectives {got} (and "
                f"{other or 'nothing else'}, {reads} host reads) != declared {want} "
                f"(collective_signature() {signature}, {iters} closure iterations)",
            ))
        elif record is not None and s < len(record) and (
            record[s]["all_to_all"] != got["all_to_all"]
            or 1 + record[s]["pmax_boundary"] + record[s]["pmax_closure"] != got["pmax"]
            or record[s]["closure_iters"] != iters
        ):
            findings.append(Finding(
                "JX02", label,
                f"superstep {s}: the program's own tally {record[s]} differs from "
                f"the collectives that reached the mesh {got} ({iters} closure "
                "iterations)",
            ))
    if record is not None and len(record) != len(steps):
        findings.append(Finding(
            "JX02", label,
            f"the program recorded {len(record)} supersteps, the mesh saw {len(steps)}",
        ))
    cond = 1 if len(steps) < m_max else 0  # the last, false superstep condition
    kinds = _kinds(tail)
    reads = sum(ev[0] == "read" for ev in tail)
    epi = dict(kinds)
    epi["all_reduce:max"] = epi.get("all_reduce:max", 0) - cond
    epi = {k: v for k, v in epi.items() if v}
    if epi != MESH_WINDOW_EPILOGUE or reads != cond:
        findings.append(Finding(
            "JX02", label,
            f"window epilogue collectives {epi} ({reads} host reads) != declared "
            f"{MESH_WINDOW_EPILOGUE} after {'a final' if cond else 'no'} superstep condition: "
            "a dropped counter sum ships per-rank partial counters as if global",
        ))
    return findings


def check_rank_logs(logs: list[list], label: str) -> list[Finding]:
    """Every rank's ordered collective log must equal rank 0's."""
    findings = []
    base = logs[0]
    for r, log in enumerate(logs[1:], start=1):
        if log == base:
            continue
        i = next(
            (j for j, (a, b) in enumerate(zip(base, log)) if a != b), min(len(base), len(log))
        )
        a = base[i] if i < len(base) else "end of log"
        b = log[i] if i < len(log) else "end of log"
        findings.append(Finding(
            "JX02", label,
            f"rank-conditional collective: rank {r}'s ordered collective log "
            f"differs from rank 0's at call {i} ({b} vs {a}; {len(log)} vs "
            f"{len(base)} calls): a rank that skips a collective deadlocks the others",
        ))
    return findings


def collective_log(events: list) -> list[tuple]:
    """The collectives of an event stream, in order."""
    return [ev[1:] for ev in events if ev[0] == "collective"]


# -- JX05: reduction identity -------------------------------------------------


def check_identity(program, label: str) -> list[Finding]:
    """The program's identity must equal the kernel layer's dtype-derived
    identity and be a numerical fixed point of relax/combine."""
    findings = []
    program = validate_program(program)
    dt = np.dtype(program.dtype)
    ident = program.identity
    expected = _identity_scalar(program.reduce, dt)
    same_val = (ident == expected) or (
        np.issubdtype(dt, np.floating)
        and np.isinf(ident) and np.isinf(expected) and ident > 0 and expected > 0
    )
    if not same_val or np.asarray(ident).dtype != np.asarray(expected).dtype:
        findings.append(Finding(
            "JX05", label,
            f"identity {ident!r} != the dtype-derived identity {expected!r} of "
            f"reduce='{program.reduce}' over {dt.name} -- kernel padding and "
            "engine padding would disagree",
        ))
        return findings
    samples = torch.as_tensor(
        np.asarray([0.0, 1.5, 7.0] if np.issubdtype(dt, np.floating) else [0, 1, 7], dtype=dt)
    )
    ivec = torch.full(samples.shape, ident.item(), dtype=program.torch_dtype)
    comb = program.combine(ivec, samples).numpy()
    if not np.array_equal(comb, samples.numpy()):
        findings.append(Finding(
            "JX05", label,
            f"combine(identity, x) != x (got {comb.tolist()} for "
            f"{samples.tolist()}): padded lanes would corrupt reductions",
        ))
    w = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float32)
    relaxed = program.relax(ivec, w).numpy()
    if not np.array_equal(relaxed, ivec.numpy()):
        findings.append(Finding(
            "JX05", label,
            f"relax(identity, w) != identity (got {relaxed.tolist()}): padded "
            "edges would emit live messages",
        ))
    return findings


# -- JX04: cache keys, layout builds ------------------------------------------


def check_cache_key_fn(key_fn, label: str, *, n_devices: int = 4) -> list[Finding]:
    """Probe a layout cache-key function for the stale-layout bug class.

    A sound key treats dtype aliases of one map as one entry (canonical) and
    never lets two *different* maps collide (no raw ``tobytes()``
    aliasing).  ``structs.mesh_layout_key`` passes; a raw-``tobytes`` key
    fails both probes.
    """
    findings = []
    base = (np.arange(6) % n_devices).astype(np.int64)
    if key_fn(base.astype(np.int32), n_devices) != key_fn(base, n_devices):
        findings.append(Finding(
            "JX04", label,
            "cache key is dtype-sensitive: the same device map keyed as int32 "
            "vs int64 misses the cache and rebuilds the layout",
        ))
    # m16 shares m32's raw little-endian buffer byte for byte while being a
    # different map (4 partitions vs 2) -- the raw-bytes aliasing probe
    m32 = np.asarray([0, 1], dtype=np.int32)
    m16 = np.asarray([0, 0, 1, 0], dtype=np.int16)
    if key_fn(m32, n_devices) == key_fn(m16, n_devices):
        findings.append(Finding(
            "JX04", label,
            "two different device maps alias one cache key (raw-bytes keying): "
            "a re-layout would serve a stale layout",
        ))
    m_2d = m32.reshape(1, 2)
    if key_fn(m32, n_devices) == key_fn(m_2d, n_devices):
        findings.append(Finding("JX04", label, "cache key ignores the device map's shape"))
    return findings


def _fresh(pg: PartitionedGraph) -> PartitionedGraph:
    """The same graph and partition with empty caches: builds can be
    counted on it, and it pickles to the ranks without them."""
    g = pg.graph
    out = PartitionedGraph(Graph(g.n_vertices, g.src, g.dst, g.weights), pg.n_parts,
                           pg.part_of_vertex)
    if "_delta_generation" in pg.__dict__:
        out.__dict__["_delta_generation"] = pg.__dict__["_delta_generation"]
    return out


def sweep_layouts(pg, *, d_n: int, rotations=SWEEP_ROTATIONS, mirror_degrees=(None,)) -> dict:
    """Build ``mesh_edge_layout`` for each placement (the contiguous map
    rolled by each of ``rotations``) x hub threshold, revisits included, on
    a copy of ``pg`` with empty caches: the distinct layout keys, the layouts
    built (distinct objects) and the cache's size after."""
    pg = _fresh(pg)
    base = contiguous_device_map(pg.n_parts, d_n)
    layouts = [
        mesh_edge_layout(pg, np.roll(base, r), d_n, mirror_degree=md)
        for r in rotations for md in mirror_degrees
    ]
    return {
        "layout_keys": {ml.layout_key for ml in layouts},
        "builds": len({id(ml) for ml in layouts}),
        "cache_size": len(pg.__dict__["_mesh_layouts"]),
        "placements": len({mesh_layout_key(np.roll(base, r), d_n) for r in rotations}),
    }


def audit_recompile_budget(
    pg, *, d_n: int = AUDIT_MESH_WIDTH, rotations=SWEEP_ROTATIONS,
    mirror_degrees=(None,), label: str | None = None,
) -> list[Finding]:
    """Scripted placement sweep: revisiting a placement (an elastic replan
    back) or a hub threshold builds no layout again, and the sweep fits the
    layout cache.  Eager PyTorch has no jit key; what carries over from the
    reference's budget is the layout cache's."""
    label = label or f"budget/layouts/d{d_n}"
    findings = check_cache_key_fn(mesh_layout_key, label, n_devices=d_n)
    sweep = sweep_layouts(pg, d_n=d_n, rotations=rotations, mirror_degrees=mirror_degrees)
    n_degrees = len(set(mirror_degrees))
    n_layouts = sweep["placements"] * n_degrees
    if len(sweep["layout_keys"]) != n_layouts:
        findings.append(Finding(
            "JX04", label,
            f"{sweep['placements']} distinct placements x {n_degrees} mirror degrees "
            f"produced {len(sweep['layout_keys'])} layout keys",
        ))
    if n_layouts > _LAYOUT_CACHE_MAX:
        findings.append(Finding(
            "JX04", label,
            f"sweep visits {n_layouts} layouts > layout cache bound {_LAYOUT_CACHE_MAX}",
        ))
    if sweep["builds"] != n_layouts or sweep["cache_size"] != n_layouts:
        findings.append(Finding(
            "JX04", label,
            f"{sweep['builds']} layouts built and {sweep['cache_size']} cached for "
            f"{n_layouts} distinct ones: revisiting a placement rebuilds its layout",
        ))
    return findings


def _layout_mismatch_fields(a, b) -> list:
    """Field names where two ``MeshEdgeLayout``s are not byte-identical."""
    bad = []
    for f in dataclasses.fields(type(a)):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            same = (
                isinstance(va, np.ndarray) and isinstance(vb, np.ndarray)
                and va.dtype == vb.dtype and va.shape == vb.shape
                and np.array_equal(va, vb)
            )
        else:
            same = va == vb
        if not same:
            bad.append(f.name)
    return bad


def audit_delta_cycle(pg, *, d_n: int = AUDIT_MESH_WIDTH) -> list[Finding]:
    """JX04 over the streaming-mutation path: mutate -> merge -> mutate.

    Two delta generations through ``merged_mesh_layout``: every generation
    mints a *distinct* ``layout_key`` (no stale-layout hit is reachable), the
    merged layout is byte-identical to a from-scratch build of the mutated
    graph, and the merge primes the new graph's layout cache (the next
    engine adopts it instead of rebuilding).  Cycle 1 deletes a singleton
    edge and re-inserts it (content churn, shapes stable); cycle 2 inserts
    a new edge.
    """
    from repro_torch.graph.deltas import EdgeDeltaBuffer, apply_delta_buffer, merged_mesh_layout

    pg = _fresh(pg)
    label = f"budget/delta-cycle/d{d_n}"
    findings = []
    dmap = contiguous_device_map(pg.n_parts, d_n)
    layout = mesh_edge_layout(pg, dmap, d_n)
    keys_seen = {layout.layout_key}

    g = pg.graph
    n = g.n_vertices
    g_key = g.src.astype(np.int64) * n + g.dst
    uniq, counts = np.unique(g_key, return_counts=True)
    singles = uniq[counts == 1]
    e = int(np.flatnonzero(g_key == singles[0])[0])
    churn = EdgeDeltaBuffer()
    churn.delete(int(g.src[e]), int(g.dst[e]))
    churn.insert(int(g.src[e]), int(g.dst[e]), float(g.edge_weights[e]))
    grow = EdgeDeltaBuffer()
    grow.insert(int(singles[-1] // n), int(singles[-1] % n), 1.25)

    cur = pg
    for cycle, buf in enumerate((churn, grow)):
        new_pg = apply_delta_buffer(cur, buf)
        merged = merged_mesh_layout(cur, new_pg, layout)
        if merged.layout_key in keys_seen:
            findings.append(Finding(
                "JX04", label,
                f"cycle {cycle}: merged layout_key collides with an earlier "
                "generation -- a mutate->merge->mutate cycle can serve a stale "
                "layout under identical shapes",
            ))
        keys_seen.add(merged.layout_key)
        if mesh_edge_layout(new_pg, dmap, d_n) is not merged:
            findings.append(Finding(
                "JX04", label,
                f"cycle {cycle}: the merge did not prime the mutated graph's layout "
                "cache -- the next engine rebuilds from scratch",
            ))
        scratch = mesh_edge_layout(apply_delta_buffer(cur, buf), dmap, d_n)
        bad = _layout_mismatch_fields(merged, scratch)
        if bad:
            findings.append(Finding(
                "JX04", label,
                f"cycle {cycle}: merged layout differs from a from-scratch build of "
                f"the mutated graph in fields {bad}",
            ))
        cur, layout = new_pg, merged
    return findings


# -- the dense matrix ---------------------------------------------------------


def audit_dense(pg, program, backend: str, *, device="cuda") -> tuple[list[Finding], list[dict]]:
    """Run and audit the ``AUDIT_WINDOWS`` of one dense engine, chained:
    JX01 and JX03 per window, JX05 for the program.  Returns ``(findings,
    per-window stats)``."""
    program = validate_program(program)
    label = f"dense/{program.name}/{backend}"
    cfg = EngineConfig(device=str(device), backend=backend, m_max=max(AUDIT_WINDOWS))
    engine = traversal_module.TraversalEngine(pg, program=program, config=cfg)
    state = engine.init_state(list(AUDIT_SOURCES))
    findings, rows = [], []
    for i, k in enumerate(AUDIT_WINDOWS):
        f, stats, res = audit_window(engine, state, k, f"{label}/w{i}", first=i == 0)
        findings += f
        rows.append({k: v for k, v in stats.items() if k != "events"})
        state = res.state
    findings += check_identity(program, label)
    return findings, rows


class ExtraReadProgram(BfsProgram):
    """BFS whose ``relax`` reads one device value back to the host, once in
    the instance's life and uncounted: the JX01 control that must be
    flagged."""

    name = "bfs-extra-read"

    def __init__(self):
        super().__init__()
        self.armed = True

    def relax(self, msg, w):
        if self.armed:
            self.armed = False
            msg.sum().item()  # the uncounted read
        return super().relax(msg, w)


def control_extra_read(pg, backend: str, *, device="cuda") -> list[Finding]:
    """The first window of ``AUDIT_WINDOWS`` on a BFS engine with one extra
    ``.item()`` (the control): the JX01 findings it draws, which must not
    be empty."""
    program = ExtraReadProgram()
    k = AUDIT_WINDOWS[0]
    cfg = EngineConfig(device=str(device), backend=backend, m_max=k)
    engine = traversal_module.TraversalEngine(pg, program=program, config=cfg)
    state = engine.init_state(list(AUDIT_SOURCES))
    findings, _, _ = audit_window(engine, state, k, f"control/extra-read/{backend}")
    return findings


# -- the mesh matrix (one launch of ranks) ------------------------------------


def _rank_case(pg, mesh, name: str, backend: str, mirror_degree) -> dict:
    program = BUILTIN_PROGRAMS[name]()
    cfg = EngineConfig(
        device=mesh.device.type, backend=backend, mesh=mesh,
        mirror_degree=mirror_degree, m_max=max(AUDIT_WINDOWS),
    )
    engine = traversal_module.TraversalEngine(pg, program=program, config=cfg)
    prog = engine._mesh_prog
    mirrored = prog.layout.m_pad > 0
    sig = validate_collective_signature(program, mirrored=mirrored)
    tag = "" if mirror_degree is None else f"/mirror{mirror_degree}"
    label = f"mesh/{name}/{backend}/d{mesh.world_size}{tag}"
    state = engine.init_state(list(AUDIT_SOURCES))
    findings, logs, rows = [], [], []
    for i, k in enumerate(AUDIT_WINDOWS):
        where = f"{label}/rank{mesh.rank}/w{i}"
        f, stats, res = audit_window(engine, state, k, where, first=i == 0)
        findings += f + check_window_collectives(
            stats["events"], sig, where, m_max=k, record=prog.last_window_collectives,
        )
        logs.append(collective_log(stats["events"]))
        rows.append({k: v for k, v in stats.items() if k != "events"})
        state = res.state
    return {"label": label, "mirrored": mirrored, "findings": findings, "logs": logs,
            "stats": rows}


def _rank_sweep(pg, mesh, backend: str) -> dict:
    """The relayout sweep on this rank: every placement of
    ``SWEEP_ROTATIONS`` x window of ``SWEEP_WINDOWS``, counting the
    rank-layout builds."""
    pg = _fresh(pg)
    base = contiguous_device_map(pg.n_parts, mesh.world_size)
    maps = [np.roll(base, r) for r in SWEEP_ROTATIONS]
    with _recording_calls(partition_module, "_build_mesh_rank_layout") as builds:
        cfg = EngineConfig(device=mesh.device.type, backend=backend, mesh=mesh,
                           m_max=max(SWEEP_WINDOWS))
        engine = traversal_module.TraversalEngine(pg, program=SsspProgram(), config=cfg)
        state = engine.init_state(list(AUDIT_SOURCES))
        for dmap in maps:
            for k in SWEEP_WINDOWS:
                state = engine.run_window(state, k, device_of_part=dmap).state
    return {
        "builds": len(builds),
        "placements": len({mesh_layout_key(m, mesh.world_size) for m in maps}),
        "swaps": len(engine._mesh_prog.relayouts),
        "map_changes": sum(
            not np.array_equal(a, b) for a, b in zip(maps, [base] + maps[:-1])
        ),
        "cache_size": len(pg.__dict__["_mesh_rank_layouts"]),
    }


def mesh_audit_rank(pg, cases, sweep_backend: str) -> dict:
    """One rank's share of the mesh audit (``run_ranks`` target): each case
    ``(program, backend, mirror_degree)`` audited over ``AUDIT_WINDOWS``,
    then the relayout sweep on ``sweep_backend``."""
    from repro_torch.dist import partition_mesh

    mesh = RecordingMesh.wrap(partition_mesh())
    return {
        "cases": [_rank_case(pg, mesh, *case) for case in cases],
        "sweep": _rank_sweep(pg, mesh, sweep_backend),
    }


def _sweep_findings(sweep: dict, label: str) -> list[Finding]:
    findings = []
    if sweep["placements"] > _RANK_LAYOUT_CACHE_MAX:
        findings.append(Finding(
            "JX04", label,
            f"the sweep visits {sweep['placements']} placements, more than the "
            f"{_RANK_LAYOUT_CACHE_MAX} rank layouts a rank keeps",
        ))
    if sweep["builds"] != sweep["placements"]:
        findings.append(Finding(
            "JX04", label,
            f"{sweep['builds']} rank-layout builds for {sweep['placements']} "
            "placements: revisiting a placement or a window length rebuilt a layout",
        ))
    if sweep["swaps"] != sweep["map_changes"] or sweep["cache_size"] > _RANK_LAYOUT_CACHE_MAX:
        findings.append(Finding(
            "JX04", label,
            f"{sweep['swaps']} layout swaps for {sweep['map_changes']} map changes, "
            f"{sweep['cache_size']} rank layouts cached",
        ))
    return findings


def mesh_cases(backends) -> list[tuple]:
    """Each builtin program x backend, unmirrored and mirrored."""
    return [
        (p, b, md) for p in BUILTIN_PROGRAMS for b in backends
        for md in (None, AUDIT_MIRROR_DEGREE)
    ]


def audit_mesh_matrix(
    pg, *, device="cuda", backends=AUDIT_BACKENDS, d_n: int = AUDIT_MESH_WIDTH,
) -> tuple[list[Finding], dict]:
    """Every mesh case of ``backends`` on ``d_n`` ranks of one ``run_ranks``
    launch on ``device`` (the card by default): each rank audits its
    windows (JX01, JX02 per rank, JX03), the parent holds the ranks' ordered
    collective logs equal (JX02) and the relayout sweep's builds on the last
    backend (JX04).  Returns ``(findings, summary)``."""
    from repro_torch.dist import run_ranks

    cases = mesh_cases(backends)
    sweep_backend = backends[-1]
    results = run_ranks(
        mesh_audit_rank, d_n, device=resolve_device(device).type, timeout=MESH_AUDIT_TIMEOUT_S,
        args=(_fresh(pg), cases, sweep_backend),
    )
    findings = []
    summary = {"ranks": d_n, "backend": results.backend, "launch_s": results.seconds,
               "cases": []}
    for c in range(len(cases)):
        per_rank = [r["cases"][c] for r in results]
        label = per_rank[0]["label"]
        for rank_case in per_rank:
            findings += rank_case["findings"]
        for w in range(len(AUDIT_WINDOWS)):
            findings += check_rank_logs([rc["logs"][w] for rc in per_rank], f"{label}/w{w}")
        summary["cases"].append({
            "label": label, "mirrored": per_rank[0]["mirrored"],
            "collectives": sum(len(log) for rc in per_rank for log in rc["logs"]),
            "stats_rank0": per_rank[0]["stats"],
        })
    for r, res in enumerate(results):
        findings += _sweep_findings(res["sweep"], f"budget/relayout-sweep/{sweep_backend}/d{d_n}/rank{r}")
    summary["sweep"] = [res["sweep"] for res in results]
    return findings, summary


# -- the audit matrix ---------------------------------------------------------


def default_audit_graph():
    """Small weighted power-law graph with a ragged partition: big enough
    that padded shard shapes differ per rank, small enough to audit in
    seconds."""
    from repro_torch.graph.generators import rmat_graph, weighted
    from repro_torch.graph.partition import bfs_grow_partition

    g = weighted(rmat_graph(6, 4, seed=7), seed=3)
    return bfs_grow_partition(g, 5, seed=0)


def audit_tree(
    pg=None, *, device="cuda", d_n: int = AUDIT_MESH_WIDTH, summary: dict | None = None,
) -> list[Finding]:
    """The full matrix on ``device`` (a card by default; a CUDA device
    without CUDA raises) over ``pg`` (``default_audit_graph()`` when None):
    every builtin program x backend x {dense, mesh}, the mirrored mesh
    window per program and backend, the relayout sweep (one ``run_ranks``
    launch of ``d_n`` ranks for all of the mesh), the layout-budget sweeps
    (placements, and the mirror knob) and the delta cycle.  The backends
    are ``AUDIT_BACKENDS`` on a card and ``torch`` alone on the CPU.
    ``summary``, when given, receives what was audited: the dense windows'
    counts by ``program/backend`` and the mesh launch's summary."""
    device = resolve_device(device)
    backends = tuple(b for b in AUDIT_BACKENDS if b != "cuda" or device.type == "cuda")
    pg = pg if pg is not None else default_audit_graph()
    summary = {} if summary is None else summary
    summary["dense"] = {}
    findings = []
    for name, ctor in BUILTIN_PROGRAMS.items():
        for backend in backends:
            f, summary["dense"][f"{name}/{backend}"] = audit_dense(pg, ctor(), backend, device=device)
            findings += f
    f, summary["mesh"] = audit_mesh_matrix(pg, device=device, backends=backends, d_n=d_n)
    findings += f
    findings += audit_recompile_budget(pg, d_n=d_n)
    findings += audit_recompile_budget(
        pg, d_n=d_n, rotations=(0,), mirror_degrees=(None, AUDIT_MIRROR_DEGREE, None),
        label=f"budget/mirror-sweep/d{d_n}",
    )
    findings += audit_delta_cycle(pg, d_n=d_n)
    return findings
