"""Reading a ``torch.profiler`` trace of the measured window.

``summarize`` turns the profiler's events into what the result line and the
per-layer readers need:

* ``busy_s``: the union of the intervals in which any device operation
  (kernel, copy, set) ran, so overlapping operations count once;
* ``window_s``: the traced window's length on the host clock;
* ``device_s_by_name``: device seconds summed by operation name;
* ``breakdown``: the ten device operations that took most time, and the
  idle gaps between device operations summed by what the host was doing in
  each (the innermost host operation open at the gap's middle, or
  ``(host python)`` where none was).
"""

from __future__ import annotations

import numpy as np

#: idle gaps labelled one by one (the longest first); shorter ones are summed
LABELLED_GAPS = 4000
#: host operations looked back over to find one open at a gap
LOOKBACK = 256
TOP = 10


def _union(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Disjoint busy intervals covering ``[starts[i], ends[i])``."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.shape[0], dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, s.shape[0] - 1)
    return s[first], reach[last]


def summarize(events, window_s: float) -> dict:
    """``events``: ``(name, start_us, end_us, on_device)`` of every profiled
    event; ``window_s``: the traced window on the host clock."""
    dev = [(n, a, b) for n, a, b, d in events if d and b > a]
    host = [(n, a, b) for n, a, b, d in events if not d and b >= a]
    by_name: dict[str, float] = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    if not dev:
        return {"busy_s": 0.0, "window_s": window_s, "device_s_by_name": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    starts = np.array([a for _, a, _ in dev], dtype=np.float64)
    ends = np.array([b for _, _, b in dev], dtype=np.float64)
    bs, be = _union(starts, ends)
    busy_s = float((be - bs).sum()) * 1e-6
    gap_a, gap_b = be[:-1], bs[1:]
    gap_len = gap_b - gap_a
    labels = _gap_labels(host, (gap_a + gap_b) / 2, gap_len)
    idle: dict[str, float] = {}
    for label, length in labels:
        idle[label] = idle.get(label, 0.0) + length * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "device_s_by_name": by_name,
        "breakdown": {
            "device_ops": [[name[:96], secs] for name, secs in top_ops],
            "idle_gaps": [[name[:96], secs] for name, secs in top_idle],
        },
    }


def _gap_labels(host, mids: np.ndarray, lengths: np.ndarray):
    """``(label, length_us)`` of each idle gap: the longest ``LABELLED_GAPS``
    by the innermost host operation open at their middle, the rest under
    ``(shorter gaps)``."""
    order = np.argsort(-lengths, kind="stable")
    out = []
    if host:
        host = sorted(host, key=lambda ev: ev[1])
        h_start = np.array([a for _, a, _ in host], dtype=np.float64)
        h_end = np.array([b for _, _, b in host], dtype=np.float64)
    for rank, i in enumerate(order):
        if rank >= LABELLED_GAPS:
            out.append(("(shorter gaps)", float(lengths[i])))
            continue
        label = "(host python)"
        if host:
            t = mids[i]
            j = int(np.searchsorted(h_start, t, side="right")) - 1
            # the innermost open operation started last among those still open
            for k in range(j, max(-1, j - LOOKBACK), -1):
                if h_end[k] > t:
                    label = host[k][0]
                    break
        out.append((label, float(lengths[i])))
    return out


def profiler_events(prof) -> list:
    """``(name, start_us, end_us, on_device)`` of a finished
    ``torch.profiler.profile``'s events."""
    from torch.autograd import DeviceType

    return [
        (ev.name, float(ev.time_range.start), float(ev.time_range.end),
         ev.device_type == DeviceType.CUDA)
        for ev in prof.events()
    ]


def idle_pct(trace) -> float | None:
    """The device's idle share of a summarized trace, in percent:
    ``1 - busy_s / window_s``; None where nothing was traced or nothing ran
    on the device."""
    if trace is None or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
