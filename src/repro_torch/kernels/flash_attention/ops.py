"""Flash attention's entry point and its backend switch.

``flash_attention`` is the counterpart of
``repro.kernels.flash_attention.ops.flash_attention``.  It routes by
``backend`` through ``kernels.build.validate_backend``, as every entry does:

  * ``"cuda"`` -- the hand-written Hopper kernel (``kernel.flash_fwd``),
    the default on a CUDA device.  It raises on CPU tensors.
  * ``"torch"`` -- the plain version (``ref.reference_attention``), the
    only backend on the CPU.

The kernel has no backward, as the TPU kernel has none: the ``cuda``
backend raises when grad mode is on and q, k or v requires grad, so a
gradient is never dropped without an error (a training caller takes the
plain path, whose gradients flow).

The TPU wrapper's block sizes and its pads of S and d are gone.  Keys at or
past the true S are masked, so a ragged non-causal call computes what
``reference_attention`` computes (the TPU wrapper lets its zero-padded keys
take softmax weight there).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import validate_backend
from repro_torch.kernels.flash_attention.kernel import flash_fwd
from repro_torch.kernels.flash_attention.ref import reference_attention


def flash_attention(
    q: torch.Tensor,  # [B, S, H, d]
    k: torch.Tensor,  # [B, S, Hk, d]
    v: torch.Tensor,  # [B, S, Hk, d]
    *,
    causal: bool = True,
    window: int | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """``[B, S, H, d]`` attention output in q's dtype: causal and/or a
    sliding window of ``window`` keys (key j kept for query i when
    ``j > i - window``), query head ``h`` reading kv head ``h // (H // Hk)``,
    scale ``1/sqrt(d)``."""
    backend = validate_backend(backend, q.device)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} must be [B, S, H, d] and two [B, S, Hk, d]"
        )
    h, hk = q.shape[2], k.shape[2]
    if hk < 1 or h % hk:
        raise ValueError(f"flash_attention: {h} query heads do not share {hk} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if backend == "torch":
        return reference_attention(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward; call it under "
            "torch.no_grad()/inference_mode(), or take the plain path (backend='torch') "
            "for gradients"
        )
    return flash_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal, window=window
    )
