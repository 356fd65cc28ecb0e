from repro_torch.kernels.segment_sum.kernel import segment_sum_sorted
from repro_torch.kernels.segment_sum.ops import gather_rows, segment_sum, sorted_segment_sum
from repro_torch.kernels.segment_sum.ref import reference_segment_sum

__all__ = [
    "gather_rows", "reference_segment_sum", "segment_sum", "segment_sum_sorted", "sorted_segment_sum",
]
