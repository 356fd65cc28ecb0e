from repro_torch.kernels.flash_attention.kernel import flash_fwd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_rows,
    bf16_tolerance_ratio,
    reference_attention,
)

__all__ = [
    "attention_rows",
    "bf16_tolerance_ratio",
    "flash_attention",
    "flash_fwd",
    "reference_attention",
]
