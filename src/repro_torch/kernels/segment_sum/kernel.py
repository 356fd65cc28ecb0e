"""Build, binding and launch wrapper of the Hopper segment-sum kernel.

``csrc/segment_sum.cu`` sums ``[E, D]`` values into ``[N, D]`` float32 by
sorted segment ids.  A block owns a span of whole rows, whose values are one
contiguous byte range: one thread streams it through a ring in shared memory
with 16-byte-aligned bulk copies, whatever D is, and the threads sum the
runs of equal ids from there (columns across threads for D >= 32, edges
across the lanes of one warp with a segmented scan for D < 32).  A run that
lies wholly inside the span is stored to ``out``; the first and last run of
each span go to a carry buffer, which the same kernel reduces again until
one block is left (see the source's header note).  It replaces the TPU
kernel ``sorted_segment_sum_kernel`` of ``repro/kernels/segment_sum/kernel.py``.

``span_rows``, ``segment_levels`` and ``launch_grid`` are the Python mirror
of the kernel's level scheme: the tests replay it and count launches with
them.  ``segment_sum_sorted`` is the launch wrapper: CUDA tensors only,
checked; it allocates the output and the carries, has the C entry launch
every level on the current stream (one call: the host's time per level is
most of a small call's) and counts each launch in
``segment_sum_sorted.launches``.
The library is built by ``kernels/build.py`` at first use.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel, check_grid

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "segment_sum.cu"
BUILD_DIR = _HERE / "build"
NARROW_D = 32  # D below this takes the narrow path: kNarrowD in csrc/segment_sum.cu
NARROW_SPAN, WIDE_SPAN = 1024, 4096  # rows of a block's span, at most: kNarrowSpan, kWideSpan
#: a wide block's span holds at most this many float32 bytes
SPAN_BYTES = 2 << 20
#: a level of at most this many float32 bytes is the last: one block
LAST_BYTES = 512 << 10
#: smaller levels cut their spans down to keep this many blocks (two a
#: streaming multiprocessor of an H100) busy
TARGET_BLOCKS = 264
#: the kernel keeps offsets inside a span in 32 bits
_SPAN_ELEMENTS = 1 << 30
_ID_CODE = {torch.int32: 0, torch.int64: 1}
_VAL_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _rows(nbytes: int, d: int, cap: int) -> int:
    """Rows of ``d`` float32 columns in ``nbytes``, a multiple of 16 within
    ``[16, cap]``."""
    return min(cap, max(16, nbytes // (4 * d) // 16 * 16))


def span_rows(m: int, d: int) -> int:
    """The rows a block of a level of ``m`` entries sums: all ``m`` (one
    block, the last level) when they fit one block's share; else a multiple
    of 16 rows, ``m / TARGET_BLOCKS`` rounded up and capped by the span's
    size (``NARROW_SPAN`` rows below ``NARROW_D`` columns, else
    ``SPAN_BYTES`` of float32 and ``WIDE_SPAN`` rows)."""
    if d < NARROW_D:
        last, cap = NARROW_SPAN, NARROW_SPAN
    else:
        last, cap = _rows(LAST_BYTES, d, WIDE_SPAN), _rows(SPAN_BYTES, d, WIDE_SPAN)
    if m <= last:
        return m
    per_block = -(-m // TARGET_BLOCKS)
    return min(cap, -(-per_block // 16) * 16)


@functools.lru_cache(maxsize=256)
def _plan(e: int, d: int) -> tuple[tuple[int, int], ...]:
    """``(entries, span)`` of every level of a call: a level of several
    blocks leaves two carries a block, and a level of one block is the last."""
    plan = []
    while True:
        span = span_rows(e, d)
        plan.append((e, span))
        if e <= span:
            return tuple(plan)
        e = 2 * -(-e // span)


@functools.lru_cache(maxsize=256)
def _plan_array(plan: tuple[tuple[int, int], ...]):
    """The plan as the C entry's ``long long`` pairs."""
    return (ctypes.c_longlong * (2 * len(plan)))(*(x for level in plan for x in level))


def segment_levels(e: int, d: int) -> list[int]:
    """The entry count of every level a call of ``e`` rows of ``d`` columns
    runs (one launch each)."""
    return [m for m, _ in _plan(e, d)]


def launch_grid(m: int, d: int) -> tuple[int]:
    """The grid of one level: ``(blocks,)``, one a span."""
    return (-(-m // span_rows(m, d)),)


class SegmentSumKernel(CudaKernel):
    """The launch wrapper of ``csrc/segment_sum.cu`` (module docstring)."""

    error_fn = "segment_sum_error_string"

    def __init__(self, source: Path = SOURCE, build_dir: Path = BUILD_DIR,
                 defines: tuple[str, ...] = ()):
        super().__init__(source, build_dir, defines)

    def _bind(self, lib: ctypes.CDLL) -> None:
        fn = lib.segment_sum_launch
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int

    def __call__(
        self,
        ids: torch.Tensor,  # [E] int32 | int64, ascending
        vals: torch.Tensor,  # [E, D] float32 | bfloat16
        n_segments: int,
    ) -> torch.Tensor:
        """``out[n] = sum(vals[ids == n])`` in float32 on the card; ids
        outside ``[0, n_segments)`` are dropped.  Raises on anything the
        kernel does not take."""
        for name, t in (("ids", ids), ("vals", vals)):
            if t.device.type != "cuda":
                raise ValueError(
                    f"segment-sum kernel: {name} lies on {t.device}; the CUDA "
                    "kernel takes CUDA tensors only"
                )
            if not t.is_contiguous():
                raise ValueError(f"segment-sum kernel: {name} must be contiguous")
        if ids.device != vals.device:
            raise ValueError(f"segment-sum kernel: ids on {ids.device}, vals on {vals.device}")
        if ids.dtype not in _ID_CODE or ids.dim() != 1:
            raise TypeError("segment-sum kernel: ids must be a 1-D int32 or int64 tensor")
        if vals.dtype not in _VAL_CODE or vals.dim() != 2:
            raise TypeError(
                f"segment-sum kernel: vals must be [E, D] float32 or bfloat16, got "
                f"{vals.dtype} {tuple(vals.shape)}"
            )
        e, d = vals.shape
        if ids.shape[0] != e:
            raise ValueError(f"segment-sum kernel: {ids.shape[0]} ids for {e} rows")
        if n_segments < 0:
            raise ValueError(f"segment-sum kernel: n_segments {n_segments} < 0")
        out = torch.zeros((n_segments, d), dtype=torch.float32, device=vals.device)
        if e == 0 or d == 0 or n_segments == 0:
            return out
        if 16 * d >= _SPAN_ELEMENTS:
            raise ValueError(
                f"segment-sum kernel: D = {d} is too wide (at most {_SPAN_ELEMENTS // 16 - 1})"
            )
        plan = _plan(e, d)
        for m, span in plan:
            check_grid((-(-m // span),), "segment-sum kernel")
        # the carries' two parts: level i writes part i % 2 (part 0 holds
        # level 2's entries, part 1 from entry plan[1][0] on level 3's)
        part = plan[1][0] if len(plan) > 1 else 0
        size = part + (plan[2][0] if len(plan) > 2 else 0)
        carry_ids = torch.empty(size, dtype=torch.int64, device=vals.device)
        carry_vals = torch.empty((size, d), dtype=torch.float32, device=vals.device)
        fn = self.load().segment_sum_launch
        switch = vals.device.index != torch.cuda.current_device()
        with torch.cuda.device(vals.device) if switch else contextlib.nullcontext():
            rc = fn(
                _ID_CODE[ids.dtype], _VAL_CODE[vals.dtype], ids.data_ptr(), vals.data_ptr(),
                d, n_segments, len(plan), _plan_array(plan), out.data_ptr(),
                carry_ids.data_ptr(), carry_vals.data_ptr(), part,
                torch.cuda.current_stream(vals.device).cuda_stream,
            )
        self._check_rc(rc, "segment-sum kernel")
        self.launches += len(plan)  # one launch a level
        return out


#: the module's one kernel instance: ``segment_sum_sorted.launches`` is the
#: count ``chip_smoke.py`` reads around the entry point's calls
segment_sum_sorted = SegmentSumKernel()
