"""Mesh-sharded traversal: the superstep-boundary exchange as a real
collective between the ranks of a ``dist.PartitionMesh``.

``MeshTraversalProgram`` is the multi-process twin of the dense engine's
window (``TraversalEngine._window_impl``) and the port of the JAX package's
``repro.graph.mesh_exchange``.  Where the JAX package runs the whole window
inside one ``shard_map`` driven by one controller, the port runs one process
per mesh rank: each rank holds its own fixed-shape padded vertex block
``[S, n_pad]`` of the device-major layout (``MeshEdgeLayout``) and runs the
same host loop, and the ranks meet only in collectives
(``PartitionMesh.all_reduce`` / ``all_to_all``):

  * **local closure** (monotone programs): every rank relaxes its own
    partitions' local edges under ``program.relax``/``combine``; the
    iteration count is synchronized with an ``all_reduce(MAX)`` of the
    per-rank "anything improved" bit (read back to the host: the loop
    condition), so the loop structure -- and hence the work counters -- is
    the dense engine's.  Stationary programs (PageRank) take one gather pass
    per superstep and fold the accumulated messages with ``program.apply``.
  * **remote exchange**: candidate messages over this rank's remote
    out-edges are ``combine``-aggregated into static wire slots **before**
    the collective -- one message per ``(dst_vertex, dst_rank)`` -- then one
    ``all_to_all`` delivers every ``[D, w_pad]`` buffer and a
    ``scatter_reduce_`` (min) or ``index_add_`` (sum) applies the received
    aggregates.  Padded slots carry the program's identity.
  * **counters**: each rank accumulates the ``[S, k, P]`` work counters of
    its own partitions (partitions never span ranks), and one
    ``all_reduce(SUM)`` per window reconstructs the exact global integers.
    ``wire_msgs`` counts the non-identity slots put on the collectives per
    superstep (for sum programs: slots fed by at least one active edge).

Every value reduction -- the local closure over ``n_pad`` rows, the
wire-slot aggregation over ``D * w_pad`` slots and the mirror-slot
aggregation over ``D * m_pad`` slots (folded into the mirror cache) -- goes
through ``kernels.bfs_relax.ops.relax_blockmap_call`` on this rank's CSR
offsets (``MeshEdgeLayout.row_ptr``): the CUDA kernel on a card, the plain
version on the CPU.  The padding contract is the reference's: padded local
edges point at row ``n_pad - 1`` and padded wire slots at ``D * w_pad - 1``,
both with identity candidates.  A plane with no valid edge on this rank (a
rank that holds no partition, a rank with no hub edge) launches nothing.

**Hub mirroring** (``mirror_degree``): remote edges into a hub feed a
rank-local *mirror* slot instead of a wire slot, and each superstep runs a
second ``all_to_all`` that syncs one value per ``(rank, hub)`` to the hub's
owner.  Monotone programs carry a window-local mirror cache and send a slot
only when its cached value improves -- exact under ``min``: the owner
already holds a value <= the cache, so a suppressed candidate could never
change it; state, frontier and every counter except ``wire_msgs`` match the
unmirrored run.  Stationary programs sync every fed slot every superstep.

**Collective signature** (the intent of the JAX package's JX02 audit): each
window records its collectives by kind and superstep and holds them against
``validate_collective_signature(program, mirrored=m_pad > 0)``: per
superstep ``all_to_all`` rounds, no value ``psum``, ``pmax_boundary``
boundary syncs, and ``pmax_closure`` syncs per closure iteration (the
iteration's activity sync and the loop condition); plus one global
any-active sync per evaluation of the superstep condition (a rank-local
condition would let iteration counts diverge) and one ``all_reduce(SUM)``
epilogue per window, of every counter and the next superstep's partition
activity.  A window whose record differs raises.

**A rank's layout**: each rank builds and holds only its own block of the
``MeshEdgeLayout`` (``partition.mesh_rank_layout``: its planes, its receive
maps, the global vertex permutation; the ``[D, D]`` block counts that fix
the wire pads are gathered from every rank), and uploads only that.

**Dynamic re-layout**: ``ensure_layout(state, device_of_part)`` swaps the
active rank layout between windows -- rebuilt from the active one, reusing
the planes the map change leaves alone, and the old one dropped -- and
remaps the carried state with ``relayout_state``: an uneven ``all_to_all``
that moves each vertex's row from its old rank and row to its new ones, so
the global state is exact across the swap.  ``place_shard`` moves one
partition's rows to the rank its VM maps onto -- the elastic executor's
physical shard move.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graph.partition import (
    contiguous_device_map,
    mesh_rank_layout,
    partitioned_edge_layout,
)
from repro_torch.graph.program import (
    SIGNATURE_KEYS,
    SsspProgram,
    VertexProgram,
    resolve_edge_plane,
    validate_collective_signature,
    validate_program,
)
from repro_torch.graph.structs import (
    MeshEdgeLayout,
    MeshRankLayout,
    PartitionedGraph,
    mesh_layout_key,
)
from repro_torch.kernels.bfs_relax.ops import relax_blockmap_call
from repro_torch.kernels.build import validate_backend
from repro_torch.kernels.part_count.ops import part_counts

def plane_shards(pg: PartitionedGraph, program: VertexProgram, ml):
    """Per-device ``(lw, rw, mw)`` edge planes for a program: the layout's
    own weights for ``plane_key == "graph"``, else the program's ``[E]``
    plane permuted through the retained layout/shard edge ids --
    ``[D, e_pad]`` each for a ``MeshEdgeLayout``, ``[e_pad]`` for one
    rank's ``MeshRankLayout``.
    """
    plane = resolve_edge_plane(pg, program)
    if plane is None:
        return ml.lw, ml.rw, ml.mw
    pel = partitioned_edge_layout(pg)

    def shard(eid, valid, set_eid):
        return np.where(valid, plane[set_eid[eid]], 0.0).astype(np.float32)

    return (
        shard(ml.l_eid, ml.lvalid, pel.local_eid),
        shard(ml.r_eid, ml.rvalid, pel.remote_eid),
        shard(ml.m_eid, ml.mvalid, pel.remote_eid),
    )


def relayout_rows(old_layout: MeshEdgeLayout, new_layout: MeshEdgeLayout, rows, fill):
    """Remap full-width ``[..., old.state_width]`` device-major rows into
    ``new_layout``'s ``[..., new.state_width]`` shape (host numpy).

    A pure permutation through global vertex order: real rows land exactly
    once, padding rows carry ``fill`` (the program identity / an empty
    frontier), so the represented global state is bit-identical.
    """
    if old_layout.n_vertices != new_layout.n_vertices:
        raise ValueError(
            f"layouts disagree on n_vertices: {old_layout.n_vertices} vs "
            f"{new_layout.n_vertices}"
        )
    rows = np.asarray(rows)
    out = np.full((*rows.shape[:-1], new_layout.state_width), fill, dtype=rows.dtype)
    out[..., new_layout.pos_of_vertex] = rows[..., old_layout.pos_of_vertex]
    return out


def _relayout_plan(old, new, rank: int):
    """This rank's side of a state relayout: the local rows it sends (grouped
    by destination rank, vertex ascending), its send counts, the local rows
    the received values land on (grouped by source rank, vertex ascending)
    and its receive counts."""
    d_n = old.n_devices
    old_pos = np.asarray(old.pos_of_vertex)
    new_pos = np.asarray(new.pos_of_vertex)
    src_dev = old_pos // old.n_pad
    dst_dev = new_pos // new.n_pad
    mine = np.flatnonzero(src_dev == rank)
    send_v = mine[np.argsort(dst_dev[mine], kind="stable")]
    incoming = np.flatnonzero(dst_dev == rank)
    recv_v = incoming[np.argsort(src_dev[incoming], kind="stable")]
    return (
        old_pos[send_v] - rank * old.n_pad,
        np.bincount(dst_dev[mine], minlength=d_n).tolist(),
        new_pos[recv_v] - rank * new.n_pad,
        np.bincount(src_dev[incoming], minlength=d_n).tolist(),
    )


def relayout_state(
    old_layout: MeshEdgeLayout,
    new_layout: MeshEdgeLayout,
    state,
    *,
    identity,
    mesh=None,
):
    """Remap a carried window state (``dist``/``frontier`` rows plus the
    replicated ``n_supersteps`` budget) from ``old_layout`` onto
    ``new_layout``; returns the same NamedTuple type with both remapped.

    Without a mesh the rows are full-width host arrays and the remap is
    ``relayout_rows``.  On a mesh each rank holds its own
    ``[S, n_pad]`` block (the layouts may be the rank's ``MeshRankLayout``s:
    the move needs only the global vertex permutation): every vertex's row
    travels from its old rank to its new one in one uneven ``all_to_all``
    per tensor, and lands on its new local row; the ``A -> B -> A`` round
    trip is bit-identical.
    """
    if mesh is None:
        return state._replace(
            dist=relayout_rows(old_layout, new_layout, state.dist, identity),
            frontier=relayout_rows(old_layout, new_layout, state.frontier, False),
        )
    if old_layout.n_devices != mesh.world_size or new_layout.n_devices != mesh.world_size:
        raise ValueError("the layouts' device counts differ from the mesh's")
    send_rows, send_counts, recv_rows, recv_counts = _relayout_plan(
        old_layout, new_layout, mesh.rank
    )
    dev = state.dist.device
    send_t = torch.as_tensor(send_rows, device=dev)
    recv_t = torch.as_tensor(recv_rows, device=dev)

    def move(rows: torch.Tensor, fill) -> torch.Tensor:
        got = mesh.all_to_all_v(
            rows.index_select(1, send_t).t().contiguous(), send_counts, recv_counts
        )
        out = torch.full(
            (rows.shape[0], new_layout.n_pad), fill, dtype=rows.dtype, device=dev
        )
        out[:, recv_t] = got.t()
        return out

    return state._replace(
        dist=move(state.dist, np.asarray(identity).item()),
        frontier=move(state.frontier, False),
    )


def place_shard(mesh, rows, n_rows: int, owner: int, target: int, prev=None):
    """Move one partition's ``n_rows`` state rows from the rank that
    computes it (``owner``) to the rank its VM maps onto (``target``).
    Every rank calls it (a collective when the two differ) with ``rows``:
    the partition's rows on the owner, an empty tensor of the same dtype
    elsewhere.  Returns ``(rows on the target rank else None, crossed)``.

    ``crossed`` marks a move of the partition's VM between ranks
    (``prev``, the rank of its previous VM, is None for the initial
    placement, which is never a move) -- the executor's physical ledger.
    """
    crossed = prev is not None and int(prev) != int(target)
    me = mesh.rank
    if owner == target:
        return (rows if me == target else None), crossed
    send_counts = [0] * mesh.world_size
    recv_counts = [0] * mesh.world_size
    if me == owner:
        send_counts[target] = int(n_rows)
    if me == target:
        recv_counts[owner] = int(n_rows)
    got = mesh.all_to_all_v(rows.reshape(-1), send_counts, recv_counts)
    return (got if me == target else None), crossed


class _Plane(NamedTuple):
    """One rank's reduction plane on its device."""

    src: torch.Tensor  # [e_pad] int64 rank-local source row
    w: torch.Tensor  # [e_pad] float32 program plane values
    valid: torch.Tensor  # [e_pad] bool
    row_ptr: torch.Tensor | None  # [nseg + 1] int32 (the kernel's indexing)
    dst: torch.Tensor | None  # [e_pad] int64 ascending rows (the plain version's)
    slot: torch.Tensor  # [e_pad] int64 ascending rows (fed-slot counts)
    n_valid: int
    n_seg: int
    deg: torch.Tensor  # [n_pad] int32 valid out-edges of each local row
    recv: torch.Tensor | None  # [D * pad] int64 local row of each received slot


class _Parts(NamedTuple):
    """This rank's rows by partition, for exact per-partition sums
    (``kernels.part_count.ops.part_counts``)."""

    part_of: torch.Tensor  # [n_pad] int32 partition of each local row, -1 on padding
    msg_deg: torch.Tensor  # [n_pad] int32 messages a row sends: wire + mirror out-edges


class _RankConsts(NamedTuple):
    local: _Plane
    wire: _Plane
    mirror: _Plane | None
    parts: _Parts


def build_window_consts(
    pg: PartitionedGraph,
    program: VertexProgram,
    ml: MeshRankLayout,
    *,
    device,
    backend: str,
) -> _RankConsts:
    """One rank's constant tables of the window program, on ``device``: its
    planes (edge sources, program plane values, validity, and what
    ``backend`` reduces by -- CSR offsets for the kernel, int64 rows for
    the plain version), its receive maps, and its rows grouped by
    partition.  ``ml`` is the rank's own block, and only it is uploaded."""
    dev = device
    lw, rw, mw = plane_shards(pg, program, ml)

    def t(a, dtype=None):
        # host copies stay in their narrow types; widening happens on the
        # device (a rank's padded planes run to tens of millions)
        x = torch.from_numpy(np.array(a)).to(dev)
        return x if dtype is None else x.to(dtype)

    def plane(kind, src, w, valid, recv):
        rows, n_seg, n_valid = ml.plane(kind)
        src_d = t(src, torch.int64)
        valid_d = t(valid)
        slot = t(rows, torch.int64)
        return _Plane(
            src=src_d, w=t(w, torch.float32), valid=valid_d,
            row_ptr=t(ml.row_ptr(kind)) if backend == "cuda" else None,
            dst=None if backend == "cuda" else slot,
            slot=slot, n_valid=n_valid, n_seg=n_seg,
            deg=torch.bincount(src_d[valid_d], minlength=ml.n_pad).to(torch.int32),
            recv=None if recv is None else t(np.asarray(recv).reshape(-1), torch.int64),
        )

    local = plane("local", ml.lsrc, lw, ml.lvalid, None)
    wire = plane("wire", ml.rsrc, rw, ml.rvalid, ml.recv_idx)
    mirror = plane("mirror", ml.msrc, mw, ml.mvalid, ml.mrecv_idx) if ml.m_pad > 0 else None
    part_of = np.where(np.asarray(ml.pos_valid), np.asarray(ml.part_of_pos), -1)
    msg_deg = wire.deg if mirror is None else wire.deg + mirror.deg
    return _RankConsts(local, wire, mirror, _Parts(t(part_of, torch.int32), msg_deg))


class MeshTraversalProgram:
    """One rank's window program for one (graph, mesh) pair.

    ``layout`` is this rank's ``MeshRankLayout``; its constant tables
    (edge planes, CSR offsets, receive maps) are uploaded once per layout,
    and the active layout can be swapped between windows
    (``ensure_layout``).  ``host_reads`` counts the loop-condition reads;
    ``last_window_collectives`` keeps the last window's per-superstep record
    of collectives; ``relayouts`` records each swap's host seconds (layout
    rebuild, upload and state move) and what the rebuild reused.
    """

    def __init__(
        self,
        pg: PartitionedGraph,
        mesh,
        device_of_part: np.ndarray | None = None,
        program: VertexProgram | None = None,
        *,
        backend: str | None = None,
        mirror_degree: int | None = None,
    ):
        d_n = int(mesh.world_size)
        if d_n < 2:
            raise ValueError(
                "MeshTraversalProgram needs >= 2 mesh ranks; the engine uses "
                "its dense path for one-rank meshes"
            )
        if device_of_part is None:
            device_of_part = contiguous_device_map(pg.n_parts, d_n)
        self.mesh = mesh
        self.rank = int(mesh.rank)
        self.device = mesh.device
        self.pg = pg
        self.program = validate_program(program or SsspProgram())
        self._identity = self.program.identity.item()  # once, as a Python scalar
        self.backend = validate_backend(backend, self.device)
        self.mirror_degree = mirror_degree
        ml = mesh_rank_layout(
            pg, device_of_part, d_n, self.rank, mirror_degree=mirror_degree, mesh=mesh
        )
        # whether the layout mirrors depends on the partition map alone, so
        # the signature is stable across relayout swaps
        mirrored = ml.m_pad > 0
        self.signature = validate_collective_signature(self.program, mirrored=mirrored)
        expected_a2a = 2 if mirrored else 1
        if self.signature["all_to_all"] != expected_a2a or self.signature["psum"] != 0:
            raise NotImplementedError(
                f"{self.program.name}: collective_signature() declares "
                f"{self.signature}, but this engine's exchange shape is "
                f"{expected_a2a} all_to_all(s) per superstep with sums only "
                "in the epilogue"
            )
        self.host_reads = 0
        self.last_window_collectives: list[dict] = []
        self.relayouts: list[dict] = []
        self._activate(ml)

    # -- layouts -------------------------------------------------------------

    def _activate(self, ml: MeshRankLayout) -> None:
        """Make ``ml`` the active layout and upload its tables; the previous
        layout's tables are dropped (a rank holds what it runs)."""
        self._consts = None
        self.layout = ml
        self._consts = build_window_consts(
            self.pg, self.program, ml, device=self.device, backend=self.backend,
        )

    def ensure_layout(self, state, device_of_part) -> tuple:
        """Swap to this rank's layout for ``device_of_part`` (rebuilt from
        the active one, reusing what the change leaves alone) and remap the
        carried ``state`` into it.  Returns ``(state, swapped)``; a no-op
        when the map is already active.  Every rank calls it with the same
        map: the rebuild and the state move are collectives."""
        t0 = time.perf_counter()
        old = self.layout
        key = mesh_layout_key(device_of_part, old.n_devices, old.delta_generation)
        if key + (self.mirror_degree,) == old.layout_key:
            return state, False
        ml = mesh_rank_layout(
            self.pg, device_of_part, old.n_devices, self.rank, base=old,
            mirror_degree=self.mirror_degree, mesh=self.mesh,
        )
        self._activate(ml)
        state = relayout_state(old, ml, state, identity=self.program.identity, mesh=self.mesh)
        self.relayouts.append({
            "seconds": time.perf_counter() - t0, **ml.__dict__.get("_build_info", {}),
        })
        return state, True

    # -- state ---------------------------------------------------------------

    def init_state(self, sources: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's ``(state, frontier)`` block for a batch of sources: the
        program's global-order init gathered into the rank's rows (padding
        rows carry the identity / an empty frontier)."""
        prog = self.program
        state_g, fr_g = prog.init(self.pg, np.asarray(sources, dtype=np.int64))
        vop = self.layout.vertex_of_pos
        valid = vop >= 0
        s_batch = state_g.shape[0]
        state = np.full((s_batch, vop.shape[0]), prog.identity, dtype=prog.dtype)
        state[:, valid] = state_g[:, vop[valid]]
        frontier = np.zeros((s_batch, vop.shape[0]), dtype=bool)
        frontier[:, valid] = fr_g[:, vop[valid]]
        return (
            torch.from_numpy(state).to(self.device),
            torch.from_numpy(frontier).to(self.device),
        )

    def gather(self, rows: torch.Tensor) -> np.ndarray:
        """Every rank's ``[..., n_pad]`` block -> ``[..., n]`` global vertex
        order on the host (a collective)."""
        blocks = self.mesh.all_gather(rows.contiguous())  # [D, ..., n_pad]
        full = torch.movedim(blocks, 0, -2).reshape(*rows.shape[:-1], -1)
        return self.layout.gather_global(full.cpu().numpy())

    # -- the window ----------------------------------------------------------

    def window(self, dist, frontier, nst0, m_max: int):
        """Run up to ``m_max`` supersteps on the active layout; returns
        ``((dist, frontier, nst, we, wv, ms, it, sg, wire), pact, done)`` with
        ``dist``/``frontier`` this rank's blocks and every counter global."""
        c = self._consts
        mesh, prog = self.mesh, self.program
        s_batch = dist.shape[0]
        p, d_n = self.pg.n_parts, mesh.world_size
        n_global = self.pg.graph.n_vertices
        ident = self._identity
        i32 = torch.int32
        kw = dict(device=self.device)
        use_mirror = c.mirror is not None
        use_cache = use_mirror and not prog.stationary
        sig = self.signature
        counts: dict = {}
        record: list[dict] = []

        def coll(kind):
            counts[kind] = counts.get(kind, 0) + 1

        def g_any(flags, kind):  # [S] bool per rank -> [S] bool, mesh-global
            coll(kind)
            return mesh.all_reduce(flags.to(i32), "max") > 0

        def read_any(t, kind=None) -> bool:  # one host read of the global any
            if kind is not None:
                coll(kind)
            self.host_reads += 1
            return bool(mesh.all_reduce(t.any().reshape(1).to(i32), "max").item())

        def reduce(plane: _Plane, cand, base):
            # a plane with no valid edge on this rank launches nothing: every
            # candidate is the identity, so combine(base, .) is base itself
            if plane.n_valid == 0:
                return base
            return relax_blockmap_call(
                plane.row_ptr, plane.dst, cand, base, reduce=prog.reduce,
                backend=self.backend,
            )

        def identity_base(width):
            return torch.full((s_batch, width), ident, dtype=dist.dtype, **kw)

        def candidates(plane: _Plane, d, active):
            relaxed = prog.relax(d.index_select(1, plane.src), plane.w)
            return torch.where(active, relaxed, ident).to(dist.dtype).contiguous()

        def active_of(plane: _Plane, f):
            return f.index_select(1, plane.src) & plane.valid

        def fed_slots(plane: _Plane, active, send):
            if prog.reduce == "min":
                # a slot is on the wire iff some active edge fed it, which
                # for min-programs is exactly "the aggregate is not identity"
                return (send != ident).sum(dim=1).to(i32)
            hits = torch.zeros((s_batch, plane.n_seg), dtype=i32, **kw)
            hits.index_add_(1, plane.slot, active.to(i32))
            return (hits > 0).sum(dim=1).to(i32)

        def all_to_all(send, pad):  # [S, D*pad] -> [S, D*pad], block j from rank j
            coll("all_to_all")
            blocks = send.view(s_batch, d_n, pad).transpose(0, 1).contiguous()
            got = mesh.all_to_all(blocks)
            return got.transpose(0, 1).reshape(s_batch, d_n * pad)

        def receive(acc, plane: _Plane, recv):
            if prog.reduce == "min":
                return acc.scatter_reduce(
                    1, plane.recv.expand(s_batch, -1), recv, reduce="amin", include_self=True
                )
            return acc.index_add(1, plane.recv, recv)

        def exchange(d_src, active_re):
            cand = candidates(c.wire, d_src, active_re)
            send = reduce(c.wire, cand, identity_base(c.wire.n_seg))
            wire_s = fed_slots(c.wire, active_re, send)
            return all_to_all(send, self.layout.w_pad), wire_s

        def part_sums(x, *weights):
            return part_counts(x, weights, c.parts.part_of, p, self.backend)

        def stationary_superstep(d, fr, nst):
            nst = nst + g_any(fr.any(dim=1), "pmax_boundary").to(i32)
            active_le = active_of(c.local, fr)
            acc = reduce(c.local, candidates(c.local, d, active_le), identity_base(d.shape[1]))
            # every message a row sends goes out in this superstep: the wire's
            # and, on a mirrored layout, the mirror's
            we_s, wv_s, ms_s = part_sums(fr, c.local.deg, None, c.parts.msg_deg).split(s_batch)
            it_s = g_any(fr.any(dim=1), "pmax_boundary").to(i32)
            active_re = active_of(c.wire, fr)
            recv, wire_s = exchange(d, active_re)
            acc = receive(acc, c.wire, recv)
            if use_mirror:
                # stateless mirror: apply() is arbitrary, so every
                # superstep's aggregate must arrive
                active_me = active_of(c.mirror, fr)
                msend = reduce(
                    c.mirror, candidates(c.mirror, d, active_me), identity_base(c.mirror.n_seg)
                )
                wire_s = wire_s + fed_slots(c.mirror, active_me, msend)
                acc = receive(acc, c.mirror, all_to_all(msend, self.layout.m_pad))
            new_d = prog.apply(d, acc, n_global)
            next_fr = fr & prog.keep_running(nst)[:, None]
            return new_d, next_fr, nst, we_s, wv_s, ms_s, it_s, wire_s, 0

        def monotone_superstep(d, fr, nst, mcache):
            nst = nst + g_any(fr.any(dim=1), "pmax_boundary").to(i32)
            # -- local closure: the same iteration count on every rank ------
            # (the superstep condition just found a global frontier, so the
            # first iteration always runs)
            d_i, f_i, touched = d, fr, fr
            we_s = torch.zeros((s_batch, p), dtype=i32, **kw)
            wv_s = torch.zeros_like(we_s)
            it_s = torch.zeros((s_batch,), dtype=i32, **kw)
            iters, go = 0, True
            while go:
                active_e = active_of(c.local, f_i)
                new_d = reduce(c.local, candidates(c.local, d_i, active_e), d_i)
                improved = prog.is_active(new_d, d_i)
                sums = part_sums(f_i, c.local.deg, None)
                we_s = we_s + sums[:s_batch]
                wv_s = wv_s + sums[s_batch:]
                it_s = it_s + g_any(f_i.any(dim=1), "pmax_closure").to(i32)
                d_i, f_i, touched = new_d, improved, touched | improved
                iters += 1
                go = read_any(f_i, "pmax_closure")
            # -- exchange: aggregate per destination, then one all-to-all ---
            active_re = active_of(c.wire, touched)
            recv, wire_s = exchange(d_i, active_re)
            new_d = receive(d_i, c.wire, recv)
            # the wire's messages and, on a mirrored layout, the mirror's
            ms_s = part_sums(touched, c.parts.msg_deg)
            if use_cache:
                # mirror sync: combine into the window-local cache, send only
                # the slots whose best value improved
                active_me = active_of(c.mirror, touched)
                new_mc = reduce(c.mirror, candidates(c.mirror, d_i, active_me), mcache)
                msend = torch.where(prog.is_active(new_mc, mcache), new_mc, ident)
                wire_s = wire_s + (msend != ident).sum(dim=1).to(i32)
                new_d = receive(new_d, c.mirror, all_to_all(msend, self.layout.m_pad))
                mcache = new_mc
            next_fr = prog.is_active(new_d, d_i)
            return new_d, next_fr, nst, we_s, wv_s, ms_s, it_s, wire_s, iters, mcache

        we = torch.zeros((s_batch, m_max, p), dtype=i32, **kw)
        wv = torch.zeros_like(we)
        ms = torch.zeros_like(we)
        it = torch.zeros((s_batch, m_max), dtype=i32, **kw)
        wire = torch.zeros((s_batch, m_max), dtype=i32, **kw)
        # the mirror cache is window-local: the first improvement after a
        # window boundary (or a relayout, which happens only between
        # windows) re-syncs -- a harmless duplicate send, never a missed one
        mcache = identity_base(c.mirror.n_seg) if use_cache else None
        d, fr, nst = dist, frontier, nst0
        s, cond_evals = 0, 0
        while s < m_max:
            cond_evals += 1
            if not read_any(fr):  # the superstep condition: outside the tally
                break
            counts = {}
            if prog.stationary:
                out = stationary_superstep(d, fr, nst)
            else:
                out = monotone_superstep(d, fr, nst, mcache)
                mcache = out[9]
            d, fr, nst = out[0], out[1], out[2]
            we[:, s], wv[:, s], ms[:, s], it[:, s], wire[:, s] = out[3:8]
            iters = out[8]
            got = {k: counts.get(k, 0) for k in SIGNATURE_KEYS}
            want = dict(sig, pmax_closure=sig["pmax_closure"] * iters)
            if got != want:
                raise RuntimeError(
                    f"superstep {s}: collectives {got} differ from the signature "
                    f"{want} of {prog.name} ({iters} closure iterations)"
                )
            record.append(dict(got, closure_iters=iters))
            s += 1
        if cond_evals != s + (s < m_max):
            raise RuntimeError(
                f"{cond_evals} superstep conditions for {s} supersteps of {m_max}"
            )
        # -- epilogue: one SUM of every counter and the partition activity --
        pact_local = part_sums(fr, None)
        flat = torch.cat([x.reshape(-1) for x in (we, wv, ms, wire, pact_local)])
        flat = mesh.all_reduce(flat, "sum")
        sizes = [we.numel()] * 3 + [wire.numel(), pact_local.numel()]
        we, wv, ms, wire, pact = (
            x.reshape(shape) for x, shape in zip(
                torch.split(flat, sizes),
                (we.shape, wv.shape, ms.shape, wire.shape, pact_local.shape),
            )
        )
        pact = pact > 0
        done = ~pact.any(dim=1)
        sg = torch.zeros((s_batch, m_max, 0), dtype=torch.bool, **kw)  # dense-only
        self.last_window_collectives = record
        return (d, fr, nst, we, wv, ms, it, sg, wire), pact, done
