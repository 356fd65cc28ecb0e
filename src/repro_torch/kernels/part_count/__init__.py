from repro_torch.kernels.part_count.kernel import part_count
from repro_torch.kernels.part_count.ops import part_counts
from repro_torch.kernels.part_count.ref import part_counts_reference

__all__ = ["part_count", "part_counts", "part_counts_reference"]
