"""Compressed cross-rank sum with error feedback
(``repro.dist.compression`` counterpart).

``compressed_psum`` int8-quantizes its input before the reduction and
returns the quantization residual, so the caller can carry it into the next
step: error feedback keeps the accumulated sum unbiased though each step's
reduction is lossy.
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import PartitionMesh


def compressed_psum(x: torch.Tensor, mesh: PartitionMesh, err_state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum over mesh's ranks of dequantize(quantize(x + err_state)),
    the new residual)``, both in ``x``'s dtype.

    Every rank must call it (a collective).  The scale is this rank's
    absmax / 127; values round half to even and clip to +-127 as int8; the
    residual is ``(x + err) - dequantized``.
    """
    y = (x + err_state).to(torch.float32)
    scale = torch.clamp(y.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    new_err = y - deq
    total = deq if mesh.world_size == 1 else mesh.all_reduce(deq, op="sum")
    return total.to(x.dtype), new_err.to(x.dtype)
