"""Run one cell of the benchmark once.

    python -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds the configuration's graph on the
card (the instance its file names), partitions it with the program's
partitioner, builds the engine, warms the cell's own shapes, then drives the
system under test for the window, the order of its sources drawn from the
seed: a closed loop of batched traversals or an open loop of served
queries (``bench.loops``).  Once the window has closed it reads the peak
device memory, frees the program, recomputes a sample of the answers with
the plain reference and compares (``bench.check``).  The last line of
standard output is the result; the numbers compared, each beside its limit,
are the last lines of standard error.  ``--trace 1`` profiles the start of
the window and reports the per-layer metrics instead of the end-to-end
ones.

Without a CUDA card the run prints no result and exits 2; if ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` was loaded, it exits 3.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names a run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _setup_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


class _Ctx:
    """The system under test as the loops see it."""

    def __init__(self, session, engine, program, pg, instance: int, service=None):
        self.session, self.engine, self.program, self.pg = session, engine, program, pg
        self.instance = instance
        self.service = service
        self.n = pg.graph.n_vertices


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _nvidia_smi() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def build(cell, seed: int, device: str, backend: str | None):
    """Set-up of one run: the configuration's graph instance, the program's
    partition and engine, and a warm batch or call of the cell's own shapes
    (its sources drawn from ``seed``).
    Returns ``(ctx, graph, spans)``; the benchmark's copy of the graph is
    left on the host, and the peak memory counts from the partition on."""
    import torch

    from bench import graphs, loops, spec
    from bench import traffic as traffic_gen
    from repro_torch.graph import Graph, bfs_grow_partition
    from repro_torch.graph.config import EngineConfig
    from repro_torch.graph.session import open_session

    gen_mod = spec.generator(cell.config["generator"])
    prog_mod = spec.program(cell.traffic["program"])
    spans = {}
    instance = int(cell.config["instance_seed"])
    t = time.perf_counter()
    g = gen_mod.generate(cell.config, instance, device)
    loops.sync(device)
    spans["generate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    graph = Graph(
        g.n,
        g.src.to(torch.int32).cpu().numpy(),
        g.dst.to(torch.int32).cpu().numpy(),
        g.weights.cpu().numpy(),
    )
    # the benchmark's own copy waits on the host until the check
    g = graphs.BenchGraph(g.n, g.src.cpu(), g.dst.cpu(), g.weights.cpu(), g.n_components)
    spans["to_host_s"] = time.perf_counter() - t
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    part_seed = int(traffic_gen.rng(instance, traffic_gen.PARTITION).integers(2**31))
    pg = bfs_grow_partition(graph, int(cell.config["parts"]), seed=part_seed)
    spans["partition_s"] = time.perf_counter() - t

    program = prog_mod.port_program()
    session = open_session(pg, EngineConfig(device=device, backend=backend))
    loops.sync(device)
    t = time.perf_counter()
    engine = session.engine(program)
    loops.sync(device)
    spans["layout_s"] = time.perf_counter() - t

    kind = cell.traffic["loop"]
    t = time.perf_counter()
    if kind == "closed":
        ctx = _Ctx(session, engine, program, pg, instance)
        warm = next(traffic_gen.batch_sources(g.n, int(cell.traffic["batch"]), seed, traffic_gen.WARM))
        session.run(program, warm)
    elif kind == "open":
        from repro_torch.serve import ServiceConfig, TraversalQuery, TraversalService

        service = TraversalService(
            pg, config=ServiceConfig(**cell.traffic.get("service", {})),
            default_program=program, engine_config=session.config,
        )
        ctx = _Ctx(session, engine, program, pg, instance, service)
        # a full batch and one more: the window and a backfill
        warm = traffic_gen.rng(seed, traffic_gen.WARM).integers(
            0, g.n, size=service.config.s_batch + 1
        )
        service.run(tuple((0.0, TraversalQuery(int(s), None, None)) for s in warm))
    else:
        raise ValueError(f"traffic loop must be 'closed' or 'open', got {kind!r}")
    loops.sync(device)
    spans["warm_s"] = time.perf_counter() - t
    return ctx, g, spans


def run_cell(
    root: Path,
    workload: str,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    device: str = "cuda",
    backend: str | None = "cuda",
    origin: float | None = None,
    cell=None,
) -> tuple[dict, dict]:
    """One run of ``workload``: ``(result line, run record)``.

    ``origin`` is the host-clock reading of the process's start (set-up is
    timed from it); ``cell`` overrides the files (the tests pass small
    configurations).  ``device="cpu"`` with ``backend="torch"`` runs the
    whole path on the CPU for the tests; a run of the benchmark is on the
    card.
    """
    import numpy as np
    import torch

    from bench import check, graphs, loops, roofline, spec
    from bench import traffic as traffic_gen
    from repro_torch.graph.partition import partitioned_edge_layout

    origin = time.perf_counter() if origin is None else origin
    cell = cell or spec.load_cell(root, workload)
    prog_mod = spec.program(cell.traffic["program"])
    ctx, g, spans = build(cell, seed, device, backend)
    kind = cell.traffic["loop"]
    loop = loops.closed_loop if kind == "closed" else loops.open_loop
    tracer = loops.Tracer(trace, device)
    spans["setup_s"] = time.perf_counter() - origin
    out = loop(ctx, cell.traffic, seconds, seed, tracer)
    loops.sync(device)
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0

    # -- the window is closed: free the program, then check ------------------
    kept = out.pop("kept")
    layout = partitioned_edge_layout(ctx.pg)
    record = {
        "spans": spans,
        "counters": out.pop("counters"),
        "loop": out,
        "relax_shapes": {
            "s": int(cell.traffic.get("batch", 0)), "n": g.n,
            "e_local": int(layout.local.n_edges), "e_remote": int(layout.remote.n_edges),
        },
        "trace": None,
        "peaks": roofline.PEAKS.get(torch.cuda.get_device_name(device))
        if device.startswith("cuda") else None,
    }
    del ctx, layout
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    if tracer.prof is not None:
        from bench import trace as trace_mod

        record["trace"] = trace_mod.summarize(trace_mod.profiler_events(tracer.prof), tracer.window_s)
        tracer.prof = None

    if kind == "closed":
        pick = traffic_gen.rng(seed, traffic_gen.CHECK)
        chosen = sorted(pick.choice(len(kept), size=min(int(cell.traffic["check_sample"]), len(kept)),
                                    replace=False).tolist())
        got_rows = [torch.as_tensor(kept[i][1]) for i in chosen]
        sources = [kept[i][0] for i in chosen]
    else:
        got_rows = [row.cpu() for _, row in kept]
        sources = [s for s, _ in kept]
    del kept
    t = time.perf_counter()
    g = graphs.BenchGraph(g.n, g.src.to(device), g.dst.to(device), g.weights.to(device),
                          g.n_components)
    numbers = {"failed": float(out["failed"])}
    if sources:
        ref = prog_mod.reference_rows(g, sources).cpu()
        numbers[prog_mod.NUMBER] = prog_mod.compare(torch.stack(got_rows), ref)
    spans["check_s"] = time.perf_counter() - t
    correct, table = check.verdict(numbers, cell.limits)

    values = {"setup_s": spans["setup_s"]}
    edges = graphs.traversed_edges(g, None, 0)
    if kind == "closed":
        values["gteps"] = out["completed"] * edges / out["window_s"] / 1e9
    else:
        lat = out["latency"]
        values["query_p95_s"] = float(np.percentile(lat, 95)) if np.isfinite(lat).all() \
            else math.inf
        values["query_p50_s"] = float(np.percentile(lat, 50))
    record["values"] = values
    record["checked"] = len(sources)
    record["graph"] = {"n": g.n, "undirected_edges": g.n_undirected,
                       "components_of_draw": g.n_components}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(root, m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {
            m["name"]: {"value": _finite(values[m["name"]]), "unit": m["unit"]}
            for m in cell.end_to_end
        }
    dev = {
        "platform": "gpu" if device.startswith("cuda") else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.startswith("cuda") else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {
        "correct": bool(correct),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": dev,
    }
    if trace and record["trace"] is not None:
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = record["trace"]["breakdown"]
    result["checks"] = table
    return result, record


def _finite(v: float):
    return v if math.isfinite(v) else None


def main(argv=None) -> int:
    age = _process_age_s()
    origin = time.perf_counter() - age
    ap = argparse.ArgumentParser(prog="python -m bench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_env(ROOT)

    from bench import spec

    cell = spec.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    result, record = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              origin=origin, cell=cell)
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {', '.join(found)}; it may load none of "
              f"{', '.join(FORBIDDEN)}", file=sys.stderr)
        return 3
    print(json.dumps({"card": _nvidia_smi(), "spans": record["spans"],
                      "values": record["values"], "graph": record["graph"],
                      "relax_shapes": record["relax_shapes"],
                      "counters": record["counters"],
                      "loop": {k: v for k, v in record["loop"].items() if k != "latency"},
                      "checked": record["checked"]}), file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} = {row['value']} (limit {row['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
