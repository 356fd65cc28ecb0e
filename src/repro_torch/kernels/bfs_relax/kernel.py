"""Build, binding and launch wrapper of the Hopper relax kernel.

``csrc/relax.cu`` computes ``combine(base, segment_reduce(cand, dst))`` over
dst-sorted edges given by their CSR offsets ``row_ptr``, split by merge
path: every block takes ``TILE_ITEMS`` items of the merged list of row ends
and edges, whatever the degrees, and rows cut by a tile boundary are folded
by a fix-up kernel (see the source's header note for the design and its
bound).  It replaces the TPU kernel ``relax_kernel_blockmap`` of
``repro/kernels/bfs_relax/kernel.py``.

The shared library is compiled by ``kernels/build.py`` (``nvcc`` for
``sm_90a`` at first use, into ``build/`` beside this file, named by a hash
of the source and flags) and loaded with ``ctypes``.  A failed build raises
``KernelBuildError``; nothing falls back to the plain version.

``relax_rowptr`` is the launch wrapper: it takes CUDA tensors only, checks
them, allocates the output and the scratch of cut-row partials, launches
the reduction and fix-up kernels (and, for a ``row_ptr`` it has not split
yet or that was edited in place since, the partition kernel, whose tile
starts it keeps while that tensor lives) on the current stream and counts
each such call once in ``relax_rowptr.launches``, and per template instantiation
(``"float32-min"``, ``"int32-min"``, ``"float32-sum"``, ``"int32-sum"``) in
``relax_rowptr.variant_launches``; the calls that also ran the partition
kernel are counted in ``relax_rowptr.partition_launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.kernels.build import (  # noqa: F401  (KernelBuildError re-exported)
    CudaKernel,
    KernelBuildError,
    check_grid,
)

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "relax.cu"
BUILD_DIR = _HERE / "build"
#: merged items (row ends + edges) per tile: kTile in csrc/relax.cu
TILE_ITEMS = 2048
_DTYPE_CODE = {torch.float32: 0, torch.int32: 1}
_REDUCE_CODE = {"min": 0, "sum": 1}
#: the kernel's template instantiations, ``"<dtype>-<reduce>"``
_VARIANT = {
    (dt, r): f"{str(dt).removeprefix('torch.')}-{r}" for dt in _DTYPE_CODE for r in _REDUCE_CODE
}
VARIANTS = tuple(_VARIANT.values())


def tile_count(n: int, e: int) -> int:
    """Tiles of ``TILE_ITEMS`` merged items over ``n`` row ends and ``e`` edges."""
    return -(-(n + e) // TILE_ITEMS)


def launch_grids(s: int, n: int, e: int) -> tuple[tuple[int], ...]:
    """The three launches' grids (blocks of 256 threads): the partition (a
    thread per tile boundary), the reduction (a block per tile) and the
    fix-up (a warp per source and tile)."""
    tiles = tile_count(n, e)
    return (-(-(tiles + 1) // 256),), (tiles,), (-(-(tiles * s * 32) // 256),)


class RelaxKernel(CudaKernel):
    """The launch wrapper of ``csrc/relax.cu`` (see the module docstring).

    ``launches`` counts kernel launches and nothing else, and
    ``variant_launches`` splits that count by template instantiation;
    ``partition_launches`` counts the calls that split a new ``row_ptr``;
    ``build_seconds`` and ``build_log`` record the first-use build.
    """

    error_fn = "relax_error_string"

    def __init__(
        self, source: Path = SOURCE, build_dir: Path = BUILD_DIR, defines: tuple[str, ...] = ()
    ):
        super().__init__(source, build_dir, defines)
        self.variant_launches = dict.fromkeys(VARIANTS, 0)
        self.partition_launches = 0
        # row_ptr -> (its version, n, e, tile starts): the split depends on
        # row_ptr alone, so a layout's later calls skip the partition kernel
        self._starts = WeakTensorKeyDictionary()

    def _bind(self, lib: ctypes.CDLL) -> None:
        fn = lib.relax_rowptr_launch
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.relax_tile_items.restype = ctypes.c_int
        if lib.relax_tile_items() != TILE_ITEMS:
            raise KernelBuildError(
                f"relax.cu tiles {lib.relax_tile_items()} items, kernel.py {TILE_ITEMS}"
            )

    def __call__(
        self,
        row_ptr: torch.Tensor,  # [n + 1] int32 CSR offsets of an ascending dst
        cand: torch.Tensor,  # [S, E] float32 | int32, identity where inactive
        base: torch.Tensor,  # [S, n] same dtype as cand
        *,
        reduce: str,
    ) -> torch.Tensor:
        """``out[s, v] = combine(base[s, v], reduce(cand[s, row_ptr[v]:
        row_ptr[v + 1]]))`` on the card; raises on anything the kernel does
        not take."""
        if reduce not in _REDUCE_CODE:
            raise ValueError(f"reduce must be 'min' or 'sum', got {reduce!r}")
        device = base.device
        for name, t in (("row_ptr", row_ptr), ("cand", cand), ("base", base)):
            if t.device != device or device.type != "cuda":
                if t.device.type != "cuda":
                    raise ValueError(
                        f"relax kernel: {name} lies on {t.device}; the CUDA kernel "
                        "takes CUDA tensors only"
                    )
                raise ValueError(f"relax kernel: {name} on {t.device}, base on {device}")
            if not t.is_contiguous():
                raise ValueError(f"relax kernel: {name} must be contiguous")
        variant = _VARIANT.get((base.dtype, reduce))
        if variant is None:
            raise TypeError(f"relax kernel: state dtype {base.dtype} unsupported")
        if cand.dtype != base.dtype:
            raise TypeError(f"relax kernel: cand {cand.dtype} != base {base.dtype}")
        if row_ptr.dtype != torch.int32 or row_ptr.dim() != 1:
            raise TypeError("relax kernel: row_ptr must be a 1-D int32 tensor")
        if cand.dim() != 2 or base.dim() != 2 or cand.shape[0] != base.shape[0]:
            raise ValueError(
                f"relax kernel: cand {tuple(cand.shape)} and base "
                f"{tuple(base.shape)} must be [S, E] and [S, n]"
            )
        s, e = cand.shape
        n = base.shape[1]
        if row_ptr.shape[0] != n + 1:
            raise ValueError(f"relax kernel: row_ptr has {row_ptr.shape[0]} rows, need {n + 1}")
        if e >= 2**31:
            raise ValueError(f"relax kernel: {e} edges overflow int32 row offsets")
        out = torch.empty_like(base)
        if out.numel() == 0:
            return out
        for grid in launch_grids(s, n, e):
            check_grid(grid, "relax kernel")
        tiles = tile_count(n, e)
        key = (row_ptr._version, n, e)
        cached = self._starts.get(row_ptr)
        partition = cached is None or cached[0] != key
        if partition:
            starts = torch.empty(2 * (tiles + 1), dtype=torch.int32, device=device)
        else:
            starts = cached[1]
        acc = torch.float64 if variant == "float32-sum" else base.dtype
        partials = torch.empty(2 * s * tiles, dtype=acc, device=device)  # head, then tail
        lib = self.load()
        with torch.cuda.device(device):
            rc = lib.relax_rowptr_launch(
                _DTYPE_CODE[base.dtype], _REDUCE_CODE[reduce],
                row_ptr.data_ptr(), cand.data_ptr(), base.data_ptr(),
                out.data_ptr(), starts.data_ptr(), int(partition), partials.data_ptr(),
                partials.data_ptr() + s * tiles * partials.element_size(), s, n, e,
                torch.cuda.current_stream(device).cuda_stream,
            )
        self._check_rc(rc, "relax kernel")
        if partition:
            self._starts[row_ptr] = (key, starts)
            self.partition_launches += 1
        self.launches += 1
        self.variant_launches[variant] += 1
        return out


#: the module's one kernel instance: ``relax_rowptr.launches`` is the count
#: ``chip_smoke.py`` reads around the main path
relax_rowptr = RelaxKernel()
