"""The yardstick's peaks and the least time of each kernel call.

Peaks are NVIDIA's published figures for the card (the SXM H100's data
sheet: dense rates, full 700 W power limit); a run names the card's power
limit beside every share it reports.  A kernel's least time is the larger of
its bytes over the card's bandwidth and its operations over the card's rate
for them, each input read once and each output written once.
"""

from __future__ import annotations

#: card name (``torch.cuda.get_device_name()``) -> peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12},
}


def relax_bytes_ops(s: int, n: int, e: int) -> tuple[int, int]:
    """One call of the relax reduction ``out[s, v] = min(base[s, v],
    min cand[s, row_ptr[v]:row_ptr[v + 1]])``: candidates ``[S, E]`` float32,
    row offsets ``[n + 1]`` int32 and the base ``[S, n]`` read once, the
    output ``[S, n]`` written once; one compare per candidate."""
    nbytes = 4 * s * e + 4 * (n + 1) + 2 * 4 * s * n
    return nbytes, s * e


def relax_least_seconds(s: int, n: int, e: int, peaks: dict) -> float:
    nbytes, ops = relax_bytes_ops(s, n, e)
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["f32_ops_per_s"])
