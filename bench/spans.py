"""The program's spans in a finished ``torch.profiler`` trace: one row per
span name, and a command that profiles a cell's first batch to print them.

    python3 -m bench.spans --workload livj-8p.sssp16 --seed 12345

builds a closed-loop cell as a run does (``bench.run.build``), profiles the
first batch of its loop (``bench.loops.Tracer``) and prints one JSON line: the
span table, the trace's ``busy_s`` and ``window_s``, the accounting of the
table against them, and the figures the table gives per batch.  Without a
CUDA card it prints nothing and exits 2.  The benchmark's own runs never
run this.

A span is a host range the program opens (``repro_torch.spans``, names
``engine.*``).  For each span name the table gives:

* ``count``: the spans of that name;
* ``host_s``: their host seconds, inclusive;
* ``device_s``: the device time of the kernels and copies launched under
  the span, through the profiler's own links: a device event's correlation
  id names the runtime call that launched it, and that call's
  ``cpu_parent`` chain leads up to the span (an op's ``kernels`` are not
  used: the profiler also hands them to its own overhead events whose id
  is the op's, "Activity Buffer Request" among them, so they count twice);
* ``self_device_s``: ``device_s`` less what its child spans launched;
* ``idle_s``: device-idle time while it is the innermost span open;
* ``idle_incl_s``: device-idle time while it is open at any depth.

Two more rows close the accounts.  ``(no program span)`` holds the device
time launched under no span (``self_device_s``) and the idle time while no
span is open (``idle_s``).  ``(remainder)`` holds the traced window's idle
time that no profiled event covers: the window's host-clock seconds less
the stretch from the profile's first event to its last, where the device
is idle (the window starts and ends synchronized).  Idle is the time
outside the union of device operations: the gaps between them, and the
head and tail of the profile.  So the ``self_device_s`` of every row add up
to the device time (``busy_s`` where no two operations overlap), and the
``idle_s`` of every row to ``window_s - busy_s``.  User-annotation events
(``torch.profiler.record_function``) are left out: their device twin spans
idle time.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from bench import trace

#: the names of the program's spans start so
PREFIX = "engine."
NO_SPAN = "(no program span)"
REMAINDER = "(remainder)"
#: the spans under which the BSP window loop runs
WINDOW = "engine.window"


def table(spans, device, window_s: float, bounds: tuple) -> dict:
    """The span table of one trace.

    ``spans``: ``(name, start_us, end_us, launched_us)`` of each span, where
    ``launched_us`` is the device time of the operations it launched while
    it was the innermost span; spans nest (they come from one thread's
    context managers).  ``device``: ``(start_us, end_us)`` of every device
    operation.  ``bounds``: ``(first_us, last_us)``, the profile's first
    event start and last event end.  ``window_s``: the traced window on the
    host clock."""
    if device:
        bs, be = trace._union(np.array([a for a, _ in device]), np.array([b for _, b in device]))
    else:
        bs, be = np.zeros(0), np.zeros(0)
    cum = np.concatenate([[0.0], np.cumsum(be - bs)])

    def busy_before(t: float) -> float:
        k = int(np.searchsorted(bs, t, side="right")) - 1
        return 0.0 if k < 0 else float(cum[k] + min(t, be[k]) - bs[k])

    def idle(a: float, b: float) -> float:
        return (b - a) - (busy_before(b) - busy_before(a))

    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    parent = [-1] * len(spans)
    stack: list[int] = []
    for i in order:
        while stack and spans[stack[-1]][2] <= spans[i][1]:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    incl_dev = [float(s[3]) for s in spans]
    incl_idle = [idle(s[1], s[2]) for s in spans]
    self_idle = list(incl_idle)
    top_idle = 0.0
    for i in reversed(order):  # children before their parents
        p = parent[i]
        if p >= 0:
            incl_dev[p] += incl_dev[i]
            self_idle[p] -= incl_idle[i]
        else:
            top_idle += incl_idle[i]
    rows: dict[str, dict] = {}
    for i, (name, a, b, launched) in enumerate(spans):
        row = rows.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0,
                                     "self_device_s": 0.0, "idle_s": 0.0, "idle_incl_s": 0.0})
        row["count"] += 1
        row["host_s"] += (b - a) * 1e-6
        row["device_s"] += incl_dev[i] * 1e-6
        row["self_device_s"] += launched * 1e-6
        row["idle_s"] += self_idle[i] * 1e-6
        row["idle_incl_s"] += incl_idle[i] * 1e-6
    device_us = sum(b - a for a, b in device)
    outside = (device_us - sum(s[3] for s in spans)) * 1e-6
    lo, hi = bounds
    rows[NO_SPAN] = {"self_device_s": outside, "idle_s": (idle(lo, hi) - top_idle) * 1e-6}
    rows[REMAINDER] = {"idle_s": window_s - (hi - lo) * 1e-6}
    return rows


def from_profile(prof, window_s: float) -> dict:
    """``table`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    return from_events(prof.events(), window_s, DeviceType.CUDA)


def from_events(events, window_s: float, on_device) -> dict:
    """``table`` of the profiler's ``FunctionEvent``s: a device event's
    launcher is the runtime call (a host event named ``cu...``) with the
    same correlation id, and its span the nearest one up that call's
    ``cpu_parent`` chain.  ``on_device`` is the device type of device
    events."""
    events = [ev for ev in events if not ev.is_user_annotation]
    if not events:
        return table([], [], window_s, (0.0, 0.0))
    spans, index, device, launch = [], {}, [], {}
    for ev in events:
        a, b = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == on_device:
            if b > a:
                device.append((a, b, ev.id))
        elif ev.name.startswith(PREFIX):
            index[id(ev)] = len(spans)
            spans.append([ev.name, a, b, 0.0])
        elif ev.name.startswith("cu"):
            launch[ev.id] = ev
    for a, b, corr in device:
        owner = launch.get(corr)
        while owner is not None and id(owner) not in index:
            owner = owner.cpu_parent
        if owner is not None:
            spans[index[id(owner)]][3] += b - a
    bounds = (min(float(ev.time_range.start) for ev in events),
              max(float(ev.time_range.end) for ev in events))
    return table([tuple(s) for s in spans], [(a, b) for a, b, _ in device], window_s, bounds)


def accounting(rows: dict, busy_s: float, window_s: float) -> dict:
    """The table against the trace: the device time of every row over
    ``busy_s``, the share of ``busy_s`` launched under ``engine.run``, and
    the idle time of every row over ``window_s - busy_s``."""
    device = sum(r.get("self_device_s", 0.0) for r in rows.values())
    idle = sum(r["idle_s"] for r in rows.values())
    run = rows.get("engine.run", {}).get("device_s", 0.0)
    return {
        "device_over_busy": device / busy_s if busy_s > 0 else None,
        "run_share_of_busy": run / busy_s if busy_s > 0 else None,
        "idle_over_window_idle": idle / (window_s - busy_s) if window_s > busy_s else None,
    }


def per_batch(rows: dict, window_s: float) -> dict:
    """What the table gives of a batch: the mean device milliseconds of one
    ``engine.counters`` and of one ``engine.gather`` span; the idle share
    of the traced window while a window is open, in percent; and the host
    milliseconds of a batch's state built, uploaded and pulled back
    (``engine.init`` and ``engine.pull`` over the ``engine.run`` count).
    A figure whose spans are not in the table, or a mean with no device
    time, is None."""

    def mean_ms(name):
        row = rows.get(name)
        return 1e3 * row["device_s"] / row["count"] if row and row["device_s"] > 0 else None

    runs = rows.get("engine.run", {}).get("count")
    io = [rows[n]["host_s"] for n in ("engine.init", "engine.pull") if n in rows]
    return {
        "counters_ms": mean_ms("engine.counters"),
        "gather_ms": mean_ms("engine.gather"),
        "loop_idle_pct": 100.0 * rows[WINDOW]["idle_incl_s"] / window_s
        if WINDOW in rows and window_s > 0 else None,
        "state_io_ms": 1e3 * sum(io) / runs if runs and len(io) == 2 else None,
    }


def profile_cell(root, cell, seed: int, device: str, backend: str) -> dict:
    """Build ``cell`` (a closed loop) as a run does, profile its first batch
    and return the report."""
    from bench import loops, run

    ctx, _, _ = run.build(cell, seed, device, backend)
    tracer = loops.Tracer(True, device)
    out = loops.closed_loop(ctx, cell.traffic, 0.0, seed, tracer)
    summary = trace.summarize(trace.profiler_events(tracer.prof), tracer.window_s)
    rows = from_profile(tracer.prof, tracer.window_s)
    batches = out.get("batches") or None
    scan = out["counters"].get("engine.scan_elems")
    figures = per_batch(rows, tracer.window_s)
    figures["scan_elems_per_batch"] = scan / batches if scan is not None and batches else None
    return {
        "workload": cell.workload,
        "seed": seed,
        "window_s": summary["window_s"],
        "busy_s": summary["busy_s"],
        "spans": rows,
        "accounting": accounting(rows, summary["busy_s"], summary["window_s"]),
        "per_batch": figures,
        "relax_traced": out.get("relax_traced"),
        "counters": out["counters"],
        "device_ops": summary["breakdown"]["device_ops"],
        "idle_gaps": summary["breakdown"]["idle_gaps"],
        "span_device_ops": sorted(n for n in summary["device_s_by_name"] if n.startswith(PREFIX)),
    }


def main(argv=None) -> int:
    from bench.run import ROOT, _nvidia_smi, _setup_env

    ap = argparse.ArgumentParser(prog="python3 -m bench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    _setup_env(ROOT)
    import torch

    from bench import spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("bench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    report = profile_cell(ROOT, cell, args.seed, "cuda", "cuda")
    report["card"] = _nvidia_smi()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
