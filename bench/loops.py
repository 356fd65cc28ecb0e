"""The two loops that drive the system under test through the measured
window, and what they keep for the check and the per-layer readers.

* ``closed_loop``: whole batches through ``GraphSession.run`` until the
  window's seconds have passed (it ends at a batch boundary).
* ``open_loop``: queries due on the mix's schedule through
  ``TraversalService.run``; each call serves the queries that came due
  since the last call returned, in their due order, and each query's
  latency runs from its due time to the return of the call that served it.

Both keep answers for the check, rows drawn from the seed, and count what
the readers need: batches, relax calls in the traced batches, service calls,
windows and occupancy.  Both also take ``counters``, every whole-number
counter of the program's objects that the loop drives, before and after the
window, and hand back the difference, so that a new reader can read any of
them.  ``Tracer`` profiles the first whole batches or calls of the window
that add up to at least ``TRACE_MIN_S``.
"""

from __future__ import annotations

import bisect
import time

import numpy as np
import torch

from bench import traffic as traffic_gen

#: the shortest stretch of the window a traced run profiles
TRACE_MIN_S = 2.0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """``torch.profiler`` over the first whole units (batches or calls) of
    the window that last ``TRACE_MIN_S`` or more; nothing when off."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.active = False
        self.prof = None
        self.window_s = 0.0

    def begin(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        sync(self.device)
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.active = True

    def after_unit(self) -> None:
        if self.active and time.perf_counter() - self.t0 >= TRACE_MIN_S:
            self.end()

    def end(self) -> None:
        if not self.active:
            return
        sync(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.active = False


def _relax_launches() -> int:
    from repro_torch.kernels.bfs_relax.kernel import relax_rowptr

    return relax_rowptr.launches


def counters(ctx) -> dict:
    """``{"<object>.<attribute>[.<key>]": n}``: every whole-number attribute
    of the engine, the relax kernel and the service (if any), and every
    entry of their dicts of whole numbers, as they stand now."""
    from repro_torch.kernels.bfs_relax.kernel import relax_rowptr

    out = {}
    for prefix, obj in (("engine", ctx.engine), ("relax", relax_rowptr), ("service", ctx.service)):
        for name, value in (vars(obj) if obj is not None else {}).items():
            if _whole(value):
                out[f"{prefix}.{name}"] = value
            elif isinstance(value, dict) and value and all(map(_whole, value.values())):
                out.update({f"{prefix}.{name}.{k}": v for k, v in value.items()})
    return out


def _whole(value) -> bool:
    return isinstance(value, int) and not isinstance(value, bool)


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def closed_loop(ctx, traffic: dict, seconds: float, seed: int, tracer: Tracer) -> dict:
    from repro_torch.graph.traversal import TraversalNotConverged

    s_batch = int(traffic["batch"])
    batches = traffic_gen.pool_batches(traffic, ctx.n, seed, ctx.instance)
    pick = traffic_gen.rng(seed, traffic_gen.SAMPLE)
    # rows kept a batch: enough that one pass over the pool holds the sample
    per_batch = min(s_batch, -(-int(traffic["check_sample"]) // int(traffic["pool_batches"])))
    kept, traced = [], {"local_calls": 0, "remote_calls": 0, "launches": 0, "batches": 0}
    attempted = failed = n_batches = 0
    before = counters(ctx)
    t0 = time.perf_counter()
    tracer.begin()
    while True:
        sources = next(batches)
        in_trace = tracer.active
        launches0 = _relax_launches()
        try:
            res = ctx.session.run(ctx.program, sources)
            stuck = np.zeros(s_batch, dtype=bool)
        except TraversalNotConverged as exc:
            res = exc.result
            stuck = np.asarray(res.frontier).any(axis=1)
        attempted += s_batch
        failed += int(stuck.sum())
        for row in pick.choice(s_batch, size=per_batch, replace=False).tolist():
            kept.append((int(sources[row]), np.array(res.dist[row])))
        if in_trace:
            # one local relax call per closure iteration of the batch (the
            # longest row's count), one remote call per superstep
            traced["local_calls"] += int(np.asarray(res.inner_iters).max(axis=0).sum())
            traced["remote_calls"] += int(np.asarray(res.n_supersteps).max())
            traced["launches"] += _relax_launches() - launches0
            traced["batches"] += 1
        n_batches += 1
        tracer.after_unit()
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    tracer.end()
    return {
        "window_s": window_s,
        "attempted": attempted,
        "failed": failed,
        "completed": attempted - failed,
        "batches": n_batches,
        "batch": s_batch,
        "counters": _delta(before, counters(ctx)),
        "relax_traced": traced,
        "kept": kept,
    }


def open_loop(ctx, traffic: dict, seconds: float, seed: int, tracer: Tracer) -> dict:
    from repro_torch.serve import MicroBatcher, TraversalQuery

    due, sources = traffic_gen.open_schedule(traffic, seconds, ctx.n, seed, ctx.instance)
    count = due.shape[0]
    sample = traffic_gen.rng(seed, traffic_gen.SAMPLE).choice(
        count, size=min(int(traffic["check_sample"]), count), replace=False
    )
    wanted = set(int(i) for i in sample)
    kept: dict[int, torch.Tensor] = {}
    first = [0]  # the call's first query: its qids count from there
    retire = MicroBatcher.retire

    def keep(self, row):
        rec = retire(self, row)
        i = first[0] + rec.qid
        if i in wanted:
            # a row retires on completion, or before a requeue: the last
            # retirement is the answer
            kept[i] = self.state.dist[row].clone()
        return rec

    latency = np.full(count, np.inf)
    calls = windows = rejected = dropped = full_calls = 0
    occupancy_windows = 0.0
    MicroBatcher.retire = keep
    try:
        before = counters(ctx)
        t0 = time.perf_counter()
        tracer.begin()
        i = 0
        while i < count:
            now = time.perf_counter() - t0
            if due[i] > now:
                time.sleep(due[i] - now)
                continue
            j = max(i + 1, bisect.bisect_right(due, now))
            trace = tuple((0.0, TraversalQuery(int(s), None, None)) for s in sources[i:j])
            first[0] = i
            rep = ctx.service.run(trace)
            done = time.perf_counter() - t0
            for q in rep.queries:
                latency[i + q.qid] = done - due[i + q.qid]
            calls += 1
            # only a call of more queries than the batch's rows backfills
            full_calls += j - i > ctx.service.config.s_batch
            windows += rep.windows
            occupancy_windows += rep.occupancy * rep.windows
            rejected += rep.rejected
            dropped += rep.dropped
            i = j
            tracer.after_unit()
        window_s = time.perf_counter() - t0
        tracer.end()
        delta = _delta(before, counters(ctx))
    finally:
        MicroBatcher.retire = retire
    served = np.isfinite(latency)
    answered = [int(k) for k in sorted(wanted) if served[k] and k in kept]
    return {
        "window_s": window_s,
        "attempted": count,
        "failed": int((~served).sum()) + len(wanted) - len(answered),
        "completed": int(served.sum()),
        "calls": calls,
        "calls_over_batch": full_calls,
        "windows": windows,
        "occupancy": occupancy_windows / windows if windows else None,
        "rejected": rejected,
        "dropped": dropped,
        "latency": latency,
        "counters": delta,
        "kept": [(int(sources[k]), kept[k]) for k in answered],
    }
