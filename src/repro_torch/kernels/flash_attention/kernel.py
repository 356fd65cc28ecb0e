"""Build, binding and launch wrapper of the Hopper flash-attention kernel.

``csrc/flash_attention.cu`` computes causal and/or sliding-window attention
with GQA in one pass over the key tiles, with the streaming softmax state
in float32 registers: bfloat16 on the tensor cores, by TMA and ``wgmma``
where TMA can take the shape (``d % 8 == 0``, 16-byte aligned bases) and by
``mma.sync`` elsewhere; float32 with plain FMAs (see the source's header
note).  It replaces the TPU kernel
``flash_attention_kernel`` of ``repro/kernels/flash_attention/kernel.py``.

``flash_fwd`` is the launch wrapper: CUDA tensors only, checked; it
allocates the output, launches on the current stream and counts launches
in ``flash_fwd.launches`` and per kernel in ``flash_fwd.variant_launches``
(``"bfloat16-wgmma"``, ``"bfloat16-mma"``, ``"float32"``); ``variant_for``
is the choice, made by dtype and shape alone.
The library is built by ``kernels/build.py`` at first use.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel, check_grid

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "flash_attention.cu"
BUILD_DIR = _HERE / "build"
MAX_HEAD_DIM = 128  # kMaxD
#: query rows per block of each kernel (kWBQ, kBQ, kFQ in the source)
_BLOCK_Q = {"bfloat16-wgmma": 128, "bfloat16-mma": 64, "float32": 32}
_VARIANT_CODE = {"float32": 0, "bfloat16-mma": 1, "bfloat16-wgmma": 2}
VARIANTS = ("float32", "bfloat16-wgmma", "bfloat16-mma")


def variant_for(d: int, dtype: torch.dtype, aligned: bool) -> str:
    """The kernel a call takes: bfloat16 goes to TMA and ``wgmma`` when
    ``d % 8 == 0`` and q, k, v start on 16 bytes (``aligned``), to
    ``mma.sync`` otherwise; float32 to its FMA kernel."""
    if dtype == torch.float32:
        return "float32"
    return "bfloat16-wgmma" if d % 8 == 0 and aligned else "bfloat16-mma"


def launch_grid(b: int, s: int, h: int, variant: str) -> tuple[int, int, int]:
    """``(query tiles, heads, batch)``: one block per query tile of a head."""
    return -(-s // _BLOCK_Q[variant]), h, b


class FlashAttentionKernel(CudaKernel):
    """The launch wrapper of ``csrc/flash_attention.cu`` (module docstring)."""

    error_fn = "flash_error_string"

    def __init__(self, source: Path = SOURCE, build_dir: Path = BUILD_DIR):
        super().__init__(source, build_dir)
        self.variant_launches = dict.fromkeys(VARIANTS, 0)

    def _bind(self, lib: ctypes.CDLL) -> None:
        fn = lib.flash_fwd_launch
        fn.argtypes = [
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int

    def __call__(
        self,
        q: torch.Tensor,  # [B, S, H, d]
        k: torch.Tensor,  # [B, S, Hk, d]
        v: torch.Tensor,  # [B, S, Hk, d]
        *,
        causal: bool,
        window: int | None,
    ) -> torch.Tensor:
        """Attention of ``q`` over ``k, v`` on the card, in q's dtype;
        raises on anything the kernel does not take."""
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.device.type != "cuda":
                raise ValueError(
                    f"flash kernel: {name} lies on {t.device}; the CUDA kernel "
                    "takes CUDA tensors only"
                )
            if t.device != q.device:
                raise ValueError(f"flash kernel: {name} on {t.device}, q on {q.device}")
            if not t.is_contiguous():
                raise ValueError(f"flash kernel: {name} must be contiguous")
            if t.dtype != q.dtype:
                raise TypeError(f"flash kernel: {name} is {t.dtype}, q is {q.dtype}")
            if t.dim() != 4:
                raise ValueError(f"flash kernel: {name} must be [B, S, heads, d]")
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash kernel: dtype {q.dtype} unsupported")
        b, s, h, d = q.shape
        hk = k.shape[2]
        if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d:
            raise ValueError(
                f"flash kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                f"{tuple(v.shape)} must be [B, S, H, d], [B, S, Hk, d], [B, S, Hk, d]"
            )
        if hk < 1 or h % hk:
            raise ValueError(f"flash kernel: {h} query heads do not share {hk} kv heads")
        if d > MAX_HEAD_DIM:
            raise ValueError(f"flash kernel: head dim {d} > {MAX_HEAD_DIM}")
        if window is not None and window < 1:
            raise ValueError(f"flash kernel: window {window} < 1")
        if s >= 2**31 or b > 65535 or h > 65535:
            raise ValueError(f"flash kernel: shape {tuple(q.shape)} too large")
        out = torch.empty_like(q)
        if out.numel() == 0:
            return out
        aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
        variant = variant_for(d, q.dtype, aligned)
        check_grid(launch_grid(b, s, h, variant), "flash kernel")
        vec = int(d % 8 == 0 and aligned)
        lib = self.load()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = lib.flash_fwd_launch(
                _VARIANT_CODE[variant], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b, s, h, hk, d, int(causal), window or 0, vec, stream,
            )
        self._check_rc(rc, "flash kernel")
        self.launches += 1
        self.variant_launches[variant] += 1
        return out


#: the module's one kernel instance: ``flash_fwd.launches`` is the count
#: ``chip_smoke.py`` reads around the entry point's calls
flash_fwd = FlashAttentionKernel()
