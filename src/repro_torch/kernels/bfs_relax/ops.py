"""Wrappers around the relax kernel + the engine backend switch.

Every entry computes ``combine(base, segment_reduce(cand, dst))`` over
dst-sorted edges and routes it by ``backend``:

  * ``"cuda"`` -- the hand-written Hopper kernel (``kernel.relax_rowptr``),
    the default on a CUDA device.  It raises on CPU tensors.
  * ``"torch"`` -- the plain version (``ref.relax_reference``), the only
    backend on the CPU; it can be asked for on the card as the comparison.

``backend=None`` picks the device's default.  The kernel walks the CSR
offsets ``row_ptr`` of the ascending ``dst`` (built once per layout on the
host and cached per device); the plain version scatters by an int64 copy of
``dst``.  Both are cached in the layout's bounded per-device cache.

  * ``relax_blockmap_call`` -- the reduction itself, given both indexings
    (the JAX package's block map ``start, cnt, t_max`` gives way to
    ``row_ptr``).
  * ``make_relax_fn`` -- the dense engine's builder: a ``(cand, base) ->
    out`` closure over one static layout.
  * ``relax_csr`` -- one program-generic relaxation pass (gather + reduce).
  * ``bfs_relax_csr`` / ``bfs_relax`` -- the min-plus entries that stood on
    the TPU's ``bfs_relax_kernel_blockmap`` and ``bfs_relax_kernel``; both
    now run the same kernel with ``reduce="min"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.structs import row_ptr_for, side_cache
from repro_torch.kernels.bfs_relax.kernel import relax_rowptr
from repro_torch.kernels.bfs_relax.ref import relax_reference
from repro_torch.kernels.build import BACKENDS, validate_backend

#: the backend policy lives in ``kernels/build.py``; these names stay here
#: for the engine and for existing imports
RELAX_BACKENDS = BACKENDS


def _identity_scalar(reduce: str, dtype):
    """The reduction identity (numpy scalar) for a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty(0, dtype=dtype).numpy().dtype
    dt = np.dtype(dtype)
    if reduce == "sum":
        return dt.type(0)
    if np.issubdtype(dt, np.floating):
        return dt.type(np.inf)
    return dt.type(np.iinfo(dt).max)


def _device_cached(layout, key: tuple, build):
    """Fetch-or-build in the layout's bounded device cache: keys are
    ``(kind, str(device))``, so a CPU copy never reaches a CUDA engine and
    vice versa."""
    return side_cache(layout, "_device_cache").get_or_build(key, build)


def layout_edges_on_device(layout, device) -> tuple[torch.Tensor, ...]:
    """``(src int32, dst int32, weights float32)`` of a layout on ``device``."""
    device = torch.device(device)
    return _device_cached(
        layout,
        ("edges", str(device)),
        lambda: tuple(
            torch.as_tensor(a, device=device)
            for a in (layout.src, layout.dst, layout.weights)
        ),
    )


def layout_index_on_device(layout, device, backend: str) -> torch.Tensor:
    """What ``backend`` reduces by: the ``[n + 1]`` int32 ``row_ptr`` for
    the kernel, the ``[E]`` int64 ``dst`` for the plain version."""
    device = torch.device(device)
    if backend == "cuda":
        return _device_cached(
            layout,
            ("row_ptr", str(device)),
            lambda: torch.as_tensor(
                row_ptr_for(layout.dst, layout.n_vertices), device=device
            ),
        )
    return _device_cached(
        layout,
        ("dst_i64", str(device)),
        lambda: torch.as_tensor(layout.dst.astype(np.int64), device=device),
    )


def relax_blockmap_call(
    row_ptr: torch.Tensor | None,  # [n + 1] int32 (the kernel's indexing)
    dst: torch.Tensor | None,  # [E] int64 ascending (the plain version's)
    cand: torch.Tensor,  # [S, E] candidates (identity where inactive)
    base: torch.Tensor,  # [S, n] base state
    *,
    reduce: str,
    backend: str | None = None,
) -> torch.Tensor:
    """``combine(base, segment_reduce(cand, dst))`` on ``backend``.

    The ``cuda`` backend reads ``row_ptr``, the ``torch`` backend ``dst``;
    the other may be None.  With no edges the result is ``base`` itself.
    """
    backend = validate_backend(backend, base.device)
    if cand.shape[1] == 0:
        return base
    if backend == "cuda":
        return relax_rowptr(row_ptr, cand, base, reduce=reduce)
    return relax_reference(dst, cand, base, reduce)


def make_relax_fn(layout, *, reduce: str, device, backend: str | None = None):
    """The dense engine's reduction over one static dst-sorted layout: a
    ``(cand [S, E], base [S, n]) -> [S, n]`` closure.  With no edges the
    closure is the combine identity (returns ``base``)."""
    backend = validate_backend(backend, device)
    if layout.n_edges == 0:
        return lambda cand, base: base
    index = layout_index_on_device(layout, device, backend)
    row_ptr, dst = (index, None) if backend == "cuda" else (None, index)

    def relax(cand, base):
        return relax_blockmap_call(
            row_ptr, dst, cand, base, reduce=reduce, backend=backend
        )

    return relax


def relax_csr(
    program,  # graph.program.VertexProgram
    state: torch.Tensor,  # [N] or [S, N], dtype = program.torch_dtype
    frontier: torch.Tensor,  # matching bool
    layout,  # CsrEdgeLayout (static, host-side)
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """One program-generic relaxation pass over a static dst-sorted layout.

    ``cand = where(frontier[src], program.relax(state[src], w), identity)``
    (torch gather), then the per-destination reduction.  Monotone programs
    (``reduce="min"``) return ``combine(state, segment_min(cand, dst))``;
    stationary programs (``reduce="sum"``) return the pre-apply accumulator
    ``segment_sum(cand, dst)``.  The plane fed to ``relax`` is
    ``layout.weights``.
    """
    squeeze = state.dim() == 1
    if squeeze:
        state, frontier = state[None], frontier[None]
    ident = _identity_scalar(program.reduce, state.dtype).item()
    base = state if program.reduce == "min" else torch.full_like(state, ident)
    if layout.n_edges == 0:
        return base[0] if squeeze else base
    device = state.device
    src, _, w = layout_edges_on_device(layout, device)
    cand = torch.where(
        frontier.index_select(1, src),
        program.relax(state.index_select(1, src), w),
        ident,
    ).to(state.dtype)
    out = make_relax_fn(layout, reduce=program.reduce, device=device, backend=backend)(
        cand.contiguous(), base.contiguous()
    )
    return out[0] if squeeze else out


def bfs_relax_csr(
    dist: torch.Tensor,  # [N] or [S, N] float32
    frontier: torch.Tensor,  # matching bool
    layout,  # CsrEdgeLayout (static, host-side)
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """``min(dist, segment_min(cand, dst))`` over a static dst-sorted layout
    (the entry the TPU's ``bfs_relax_kernel_blockmap`` served)."""
    squeeze = dist.dim() == 1
    if squeeze:
        dist, frontier = dist[None], frontier[None]
    if layout.n_edges == 0:
        return dist[0] if squeeze else dist
    src, _, w = layout_edges_on_device(layout, dist.device)
    cand = torch.where(
        frontier.index_select(1, src), dist.index_select(1, src) + w, float("inf")
    )
    out = make_relax_fn(layout, reduce="min", device=dist.device, backend=backend)(
        cand.contiguous(), dist.contiguous()
    )
    return out[0] if squeeze else out


def bfs_relax(
    dist: torch.Tensor,  # [N] float32
    frontier: torch.Tensor,  # [N] bool
    src: torch.Tensor,  # [E] int
    dst: torch.Tensor,  # [E] int
    w: torch.Tensor,  # [E] float32
    *,
    presorted: bool = False,  # dst already ascending (static edge order)
    backend: str | None = None,
) -> torch.Tensor:
    """Masked min-plus relaxation over edges in any order (the entry the
    TPU's dense-grid ``bfs_relax_kernel`` served): sorts by destination
    unless ``presorted``, then runs the same reduction with one source."""
    backend = validate_backend(backend, dist.device)
    n = dist.shape[0]
    if src.shape[0] == 0:
        return dist
    src = src.to(torch.int64)
    cand = torch.where(frontier[src], dist[src] + w, float("inf"))
    dst = dst.to(torch.int64)
    if not presorted:
        order = torch.argsort(dst, stable=True)
        dst, cand = dst[order], cand[order]
    row_ptr = None
    if backend == "cuda":
        row_ptr = torch.searchsorted(
            dst, torch.arange(n + 1, device=dst.device, dtype=torch.int64)
        ).to(torch.int32)
    out = relax_blockmap_call(
        row_ptr, dst, cand[None].contiguous(), dist[None].contiguous(),
        reduce="min", backend=backend,
    )
    return out[0]
