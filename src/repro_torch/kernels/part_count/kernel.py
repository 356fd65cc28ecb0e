"""Build, binding and launch wrapper of the Hopper partition-counter kernel.

``csrc/part_count.cu`` sums an ``[R, n]`` bool frontier, times each of up to
three per-vertex int32 weights (or ones), into ``[W * R, P]`` int32 sums
per partition: one pass that reads each frontier row once and keeps each
thread's part ids and weights in its own column of shared memory for every
row (see the source's header note for the design and its bound).  It
replaces no TPU kernel: the JAX package counts per edge with
``jax.ops.segment_sum`` under XLA.

The shared library is compiled by ``kernels/build.py`` (``nvcc`` for
``sm_90a`` at first use, into ``build/`` beside this file) and loaded with
``ctypes``; a failed build raises ``KernelBuildError``.

``launch_grid`` is the Python mirror of the launch's grid: a block for each
chunk of ``CHUNK_VERTICES`` vertices and row group of ``group_rows`` rows,
as many rows as ``COUNTER_WORDS`` shared counters hold.  ``part_count`` is the
launch wrapper: CUDA tensors only, checked; it allocates the output, which
the launch zeroes, launches on the current stream and counts each launch in
``part_count.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel, KernelBuildError, check_grid

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "part_count.cu"
BUILD_DIR = _HERE / "build"
#: vertices a block takes: kChunk in csrc/part_count.cu
CHUNK_VERTICES = 4096
#: shared uint32 counters a block holds (32 KB): kCounterWords
COUNTER_WORDS = 8192
#: weightings one launch sums: kMaxWeights
MAX_WEIGHTS = 3


def group_rows(rows: int, n_weights: int, n_parts: int) -> int:
    """Rows one block counts: all ``rows`` where their counters fit, else
    as many as ``COUNTER_WORDS`` hold (0 when not one row fits)."""
    return min(rows, COUNTER_WORDS // (n_weights * n_parts))


def launch_grid(rows: int, n: int, n_weights: int, n_parts: int) -> tuple[int, int]:
    """The launch's grid ``(chunks, row groups)``."""
    g = group_rows(rows, n_weights, n_parts)
    return -(-n // CHUNK_VERTICES), (-(-rows // g) if g else 0)


class PartCountKernel(CudaKernel):
    """The launch wrapper of ``csrc/part_count.cu`` (see the module
    docstring); ``launches`` counts kernel launches and nothing else."""

    error_fn = "part_count_error_string"

    def _bind(self, lib: ctypes.CDLL) -> None:
        fn = lib.part_count_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        for name, want in (("part_count_chunk_vertices", CHUNK_VERTICES),
                           ("part_count_counter_words", COUNTER_WORDS)):
            getattr(lib, name).restype = ctypes.c_int
            if getattr(lib, name)() != want:
                raise KernelBuildError(
                    f"part_count.cu: {name}() is {getattr(lib, name)()}, kernel.py {want}"
                )

    def __call__(
        self,
        x: torch.Tensor,  # [R, n] bool
        weights: tuple,  # W of [n] int32, or None for ones
        part_of: torch.Tensor,  # [n] int32, outside [0, P) counts nowhere
        n_parts: int,
    ) -> torch.Tensor:
        """``[W * R, P]`` int32 sums per partition on the card; raises on
        anything the kernel does not take."""
        device = x.device
        if device.type != "cuda":
            raise ValueError(
                f"part_count kernel: x lies on {device}; the CUDA kernel takes CUDA tensors only"
            )
        if x.dtype != torch.bool or x.dim() != 2 or not x.is_contiguous():
            raise TypeError("part_count kernel: x must be a contiguous 2-D bool tensor")
        rows, n = x.shape
        if not 1 <= len(weights) <= MAX_WEIGHTS:
            raise ValueError(
                f"part_count kernel: {len(weights)} weightings; one launch takes 1 to {MAX_WEIGHTS}"
            )
        for name, t in (("part_of", part_of), *(("weight", w) for w in weights if w is not None)):
            if t.device != device:
                raise ValueError(f"part_count kernel: {name} on {t.device}, x on {device}")
            if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
                raise TypeError(f"part_count kernel: {name} must be a contiguous [{n}] int32 tensor")
        n_parts = int(n_parts)
        if n_parts < 1 or len(weights) * n_parts > COUNTER_WORDS:
            raise ValueError(
                f"part_count kernel: {len(weights)} x {n_parts} counters a row; a block holds "
                f"1 to {COUNTER_WORDS}"
            )
        check_grid(launch_grid(rows, n, len(weights), n_parts), "part_count kernel")
        out = torch.empty((len(weights) * rows, n_parts), dtype=torch.int32, device=device)
        ptrs = [None if w is None else w.data_ptr() for w in weights]
        ptrs += [None] * (MAX_WEIGHTS - len(ptrs))
        lib = self.load()
        with torch.cuda.device(device):
            rc = lib.part_count_launch(
                x.data_ptr(), *ptrs, len(weights), part_of.data_ptr(), out.data_ptr(), rows, n,
                n_parts, group_rows(rows, len(weights), n_parts),
                torch.cuda.current_stream(device).cuda_stream,
            )
        self._check_rc(rc, "part_count kernel")
        self.launches += 1
        return out


#: the module's one kernel instance: ``part_count.launches`` is the count
#: the engine reads around a window
part_count = PartCountKernel(SOURCE, BUILD_DIR)
