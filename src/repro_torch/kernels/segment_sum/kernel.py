"""Build, binding and launch wrapper of the Hopper segment-sum kernel.

``csrc/segment_sum.cu`` sums ``[E, D]`` values into ``[N, D]`` float32 by
sorted segment ids, edge-parallel: a warp sums the runs of a fixed
sub-chunk of edges in registers and stores the runs that lie wholly inside
it; the first and last run of each sub-chunk go to a carry buffer, which
the same kernel reduces again until one sub-chunk is left (see the source's
header note).  It replaces the TPU kernel ``sorted_segment_sum_kernel`` of
``repro/kernels/segment_sum/kernel.py``.

``segment_sum_sorted`` is the launch wrapper: CUDA tensors only, checked;
it allocates the output and the carries, launches every level on the
current stream and counts each launch in ``segment_sum_sorted.launches``.
The library is built by ``kernels/build.py`` at first use.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel, check_grid

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "segment_sum.cu"
BUILD_DIR = _HERE / "build"
_SUB = 128  # edges per sub-chunk: kSub in csrc/segment_sum.cu
_LANES, _WARPS = 32, 8  # kLanes, kWarps
_ID_CODE = {torch.int32: 0, torch.int64: 1}
_VAL_CODE = {torch.float32: 0, torch.bfloat16: 1}


def segment_levels(e: int) -> list[int]:
    """The entry count of every level a call of ``e`` edges runs: each
    level of ``m > _SUB`` entries leaves two carries per sub-chunk, and the
    level that holds at most ``_SUB`` entries is the last."""
    levels = [e]
    while levels[-1] > _SUB:
        levels.append(2 * -(-levels[-1] // _SUB))
    return levels


def launch_grid(m: int, d: int, vec: int) -> tuple[int, int]:
    """The grid of one level: ``(blocks of sub-chunks, column slices)``."""
    n_sub = -(-m // _SUB)
    return -(-n_sub // _WARPS), -(-d // (_LANES * vec))


def _vec_width(t: torch.Tensor, d: int) -> int:
    """4 when every row starts on a 4-element vector boundary, else 1."""
    return 4 if d % 4 == 0 and t.data_ptr() % (4 * t.element_size()) == 0 else 1


class SegmentSumKernel(CudaKernel):
    """The launch wrapper of ``csrc/segment_sum.cu`` (module docstring)."""

    error_fn = "segment_sum_error_string"

    def __init__(self, source: Path = SOURCE, build_dir: Path = BUILD_DIR):
        super().__init__(source, build_dir)

    def _bind(self, lib: ctypes.CDLL) -> None:
        fn = lib.segment_sum_level_launch
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
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
        levels = segment_levels(e)
        # ping-pong carries: level i reads one buffer and writes the other
        carries = [
            (
                torch.empty(m, dtype=torch.int64, device=vals.device),
                torch.empty((m, d), dtype=torch.float32, device=vals.device),
            )
            for m in levels[1:3]
        ]
        lib = self.load()
        with torch.cuda.device(vals.device):
            stream = torch.cuda.current_stream(vals.device).cuda_stream
            src_ids, src_vals = ids, vals
            for i, m in enumerate(levels):
                last = i == len(levels) - 1
                vec = _vec_width(src_vals, d)
                check_grid(launch_grid(m, d, vec), "segment-sum kernel")
                dst_ids, dst_vals = (None, None) if last else carries[i % 2]
                rc = lib.segment_sum_level_launch(
                    _ID_CODE[src_ids.dtype], _VAL_CODE[src_vals.dtype], vec,
                    src_ids.data_ptr(), src_vals.data_ptr(), m, d, n_segments,
                    out.data_ptr(),
                    None if last else dst_ids.data_ptr(),
                    None if last else dst_vals.data_ptr(),
                    stream,
                )
                self._check_rc(rc, "segment-sum kernel")
                self.launches += 1
                src_ids, src_vals = dst_ids, dst_vals
        return out


#: the module's one kernel instance: ``segment_sum_sorted.launches`` is the
#: count ``chip_smoke.py`` reads around the entry point's calls
segment_sum_sorted = SegmentSumKernel()
