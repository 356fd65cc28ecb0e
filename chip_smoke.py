#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the paper's pipeline once on one NVIDIA card, through the port's own
entry points, at the size of the paper's LiveJournal workload (LIVJ/8P):

  1. device  -- the card's name and power limit; the relax kernel's build.
  2. graph   -- ``rmat_graph(22, 8, seed=42)`` (about 4.2 M vertices and
                68 M directed edges, SNAP soc-LiveJournal1's size) split by
                ``bfs_grow_partition(..., 8, seed=1)``; host build times.
  3. kernel  -- the CUDA relax kernel (every template instantiation the
                main path runs) held against its plain PyTorch version at the
                main path's shapes and at the degenerate shapes (no edges,
                n < 8, one edge): min bit-exact, sum within rtol=1e-5,
                atol=1e-9.  Times by CUDA events beside the bound and one
                ``scatter_reduce`` call.
  4. oracle  -- BFS, SSSP, WCC and PageRank on a small graph on the card,
                held against the port's numpy oracles.
  5. slice   -- the main path: BFS from 4 sources, WCC and 20 PageRank
                iterations through ``bsp.run_program`` on the ``cuda``
                backend, with the kernel's launch counts set to 0 just
                before and read just after.  Then the same runs on the
                ``torch`` backend on the same card: state bit-identical for
                BFS and WCC, allclose for PageRank, traces exact.  BFS
                source 0 is held against the host BFS ``_bfs_hops``.
  6. pipeline -- the BFS trace becomes the time function A, scaled to
                LIVJ's T_Min of 21 s; every placement strategy is billed at
                delta = 60 s; ``predict_time_function`` gives the
                metagraph's a-priori plan.
  7. profile -- one more BFS traversal under ``torch.profiler``: the
                card's busy share and the kernels that take its time.

Each phase prints one JSON line.  Then come the ``{"kernels": [...]}``
line, the card's ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero.  Without CUDA it exits non-zero at once and prints no
result.

    python3 chip_smoke.py                    # the full LIVJ/8P size
    python3 chip_smoke.py --scale 16         # a quick run on a smaller graph
    python3 chip_smoke.py --out smoke_report.json    # also keep the full report
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import STRATEGIES, BillingModel, TimeFunction, evaluate  # noqa: E402
from repro_torch.core.metagraph import predict_time_function  # noqa: E402
from repro_torch.graph import bsp  # noqa: E402
from repro_torch.graph.config import EngineConfig  # noqa: E402
from repro_torch.graph.generators import rmat_graph, weighted  # noqa: E402
from repro_torch.graph.partition import (  # noqa: E402
    _bfs_hops,
    bfs_grow_partition,
    partitioned_edge_layout,
)
from repro_torch.graph.program import (  # noqa: E402
    BfsProgram,
    PageRankProgram,
    SsspProgram,
    WccProgram,
)
from repro_torch.graph.traversal import (  # noqa: E402
    get_engine,
    reference_bfs,
    reference_pagerank,
    reference_sssp,
    reference_wcc,
)
from repro_torch.kernels.bfs_relax.kernel import VARIANTS, relax_rowptr  # noqa: E402
from repro_torch.kernels.bfs_relax.ops import (  # noqa: E402
    _identity_scalar,
    layout_index_on_device,
)
from repro_torch.kernels.bfs_relax.ref import relax_reference  # noqa: E402

#: H100 SXM peaks (NVIDIA's data sheet, at the full 700 W power limit):
#: HBM3 bandwidth and the float32 rate outside the tensor cores.  The
#: kernel's int32 compares are counted at the same rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

LIVJ_PARTS = 8
LIVJ_T_MIN_S = 21.0  # LIVJ's T_Min in the JAX package's data/workloads.py
BILLING_DELTA_S = 60.0
PAGERANK_ITERS = 20
BFS_SOURCES = 4
MAX_SUPERSTEPS = 256
#: PageRank's state on the kernel is held against a float64 power iteration
#: on the card.  A sum of positive terms adds no relative error beyond its own
#: roundings, and an iteration rounds at most 7 times in float32 (state,
#: plane, product, two kernel outputs, the update's multiply and add), so
#: after 20 iterations a vertex is within 20 * 7 * 2**-24 = 8.3e-6.
PAGERANK_RTOL, PAGERANK_ATOL = 1e-5, 1e-9

KERNEL_SOURCE = "src/repro_torch/kernels/bfs_relax/csrc/relax.cu"
KERNEL_REPLACES = "src/repro/kernels/bfs_relax/kernel.py:138"
#: the template instantiations the main path runs, and the program each
#: serves there: (variant, reduce, dtype, program name)
MAIN_VARIANTS = (
    ("float32-min", "min", torch.float32, "bfs"),
    ("int32-min", "min", torch.int32, "wcc"),
    ("float32-sum", "sum", torch.float32, "pagerank"),
)


def _emit(phase: str, payload: dict) -> None:
    print(json.dumps({"phase": phase, **payload}), flush=True)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------


def _median_ms(fn, reps: int) -> float:
    """Median of ``reps`` single-launch times by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def _bound(s: int, n: int, e: int) -> tuple[float, str]:
    """Least time on the card for one reduction: each input read once
    (cand, row_ptr, base) and each output written once, against the card's
    bandwidth; one compare or add per candidate against its peak rate."""
    nbytes = 4 * s * e + 4 * (n + 1) + 2 * 4 * s * n
    ops = s * e
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    diff = (a.double() - b.double()).abs()
    return float(torch.where(a == b, torch.zeros_like(diff), diff).max())


# -- phases ------------------------------------------------------------------


def phase_device() -> dict:
    smi = _nvidia_smi()
    t0 = time.perf_counter()
    relax_rowptr.load()
    build_s = time.perf_counter() - t0
    ptxas = [
        line.strip() for line in relax_rowptr.build_log.splitlines()
        if "registers" in line or "spill" in line
    ]
    return {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernel_build_s": build_s,
        "ptxas": ptxas,
    }


def build_graph(scale: int, parts: int) -> tuple[object, dict]:
    """The LIVJ-shaped graph and its partition, with host build times."""
    t0 = time.perf_counter()
    g = rmat_graph(scale, 8, seed=42)
    t1 = time.perf_counter()
    pg = bfs_grow_partition(g, parts, seed=1)
    t2 = time.perf_counter()
    layout = partitioned_edge_layout(pg)
    t3 = time.perf_counter()
    info = {
        "scale": scale,
        "n_vertices": g.n_vertices,
        "n_edges": g.n_edges,
        "n_parts": parts,
        "e_local": layout.local.n_edges,
        "e_remote": layout.remote.n_edges,
        # the longest span one warp of the relax kernel walks alone
        "max_in_degree_local": int(np.bincount(layout.local.dst, minlength=1).max()),
        "max_in_degree_remote": int(np.bincount(layout.remote.dst, minlength=1).max()),
        "edge_cut": pg.edge_cut_fraction,
        "rmat_s": t1 - t0,
        "partition_s": t2 - t1,
        "layout_s": t3 - t2,
    }
    return pg, info


def _random_case(gen, s, n, e, dtype, reduce, device, row_ptr=None, dst=None):
    """Seeded inputs for one reduction: candidates (30% identity), a base
    (30% identity for min) and a sorted dst, random unless given."""
    if dst is None:
        dst = torch.randint(0, n, (e,), generator=gen, device=device).sort().values
        row_ptr = torch.searchsorted(
            dst, torch.arange(n + 1, device=device, dtype=torch.int64)
        ).to(torch.int32)
    ident = _identity_scalar(reduce, dtype).item()

    def values(shape):
        if dtype == torch.int32:
            return torch.randint(0, max(n, 2), shape, generator=gen, device=device,
                                 dtype=torch.int32)
        return torch.rand(shape, generator=gen, device=device) * 10.0

    cand = values((s, e))
    cand[torch.rand((s, e), generator=gen, device=device) < 0.3] = ident
    base = values((s, n))
    if reduce == "min":
        base[torch.rand((s, n), generator=gen, device=device) < 0.3] = ident
    return row_ptr, dst.to(torch.int64), cand, base


def _hold_case(name, variant, reduce, row_ptr, dst, cand, base, reps) -> dict:
    """One kernel call against the plain version; times all three."""
    s, e = cand.shape
    n = base.shape[1]
    out = relax_rowptr(row_ptr, cand, base, reduce=reduce)
    ref = relax_reference(dst, cand, base, reduce)
    torch.cuda.synchronize()
    if reduce == "min":
        ok = torch.equal(out, ref)
    else:
        ok = torch.allclose(out, ref, rtol=1e-5, atol=1e-9)
    err = _max_abs_err(out, ref)
    _check(ok, f"{variant} {name} [S={s}, n={n}, E={e}] disagrees (max abs err {err})")
    idx = dst.expand(s, e)
    lib_reduce = "amin" if reduce == "min" else "sum"
    bound_ms, bound_by = _bound(s, n, e)
    return {
        "case": name, "S": s, "n": n, "E": e, "max_abs_err": err,
        "ms": _median_ms(lambda: relax_rowptr(row_ptr, cand, base, reduce=reduce), reps),
        "plain_ms": _median_ms(lambda: relax_reference(dst, cand, base, reduce), reps),
        "library_ms": _median_ms(
            lambda: base.scatter_reduce(1, idx, cand, reduce=lib_reduce, include_self=True),
            reps,
        ),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def phase_kernels(pg, seed: int, device) -> dict:
    """Every instantiation the main path runs, at its shapes and at the
    degenerate ones, against the plain version."""
    layout = partitioned_edge_layout(pg)
    n = pg.graph.n_vertices
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for variant, reduce, dtype, prog in MAIN_VARIANTS:
        s_main = BFS_SOURCES if prog == "bfs" else 1
        cases = []
        for name, lay in (("main-local", layout.local), ("main-remote", layout.remote)):
            row_ptr = layout_index_on_device(lay, device, "cuda")
            dst = layout_index_on_device(lay, device, "torch")
            args = _random_case(gen, s_main, n, lay.n_edges, dtype, reduce, device,
                                row_ptr=row_ptr, dst=dst)
            cases.append(_hold_case(name, variant, reduce, *args, reps=10))
        shapes = (
            ("random-s4", BFS_SOURCES, n, layout.local.n_edges, 10),
            ("e0", BFS_SOURCES, 64, 0, 50),
            ("n_lt_8", BFS_SOURCES, 5, 9, 50),
            ("single_edge", BFS_SOURCES, 40, 1, 50),
        )
        for name, s, nn, e, reps in shapes:
            args = _random_case(gen, s, nn, e, dtype, reduce, device)
            cases.append(_hold_case(name, variant, reduce, *args, reps=reps))
        out[variant] = cases
        torch.cuda.empty_cache()
    return out


def phase_oracles(device, seed: int) -> dict:
    """All four programs on a small graph on the card, against the numpy
    oracles (hops and labels exact; SSSP rtol=1e-6 and PageRank rtol=1e-5,
    atol=1e-9 against float64 sums)."""
    g = weighted(rmat_graph(10, 8, seed=seed), seed=seed + 1)
    pg = bfs_grow_partition(g, 8, seed=seed)
    cfg = EngineConfig(device=str(device), backend="cuda")
    sources = [0, 17, 300]
    checked = {}
    for prog in (BfsProgram(), SsspProgram(), WccProgram(), PageRankProgram()):
        dist, _ = bsp.run_program(pg, prog, sources, max_supersteps=128, config=cfg)
        for i, s in enumerate(sources):
            if prog.name == "bfs":
                np.testing.assert_array_equal(dist[i], reference_bfs(pg, s))
            elif prog.name == "sssp":
                np.testing.assert_allclose(dist[i], reference_sssp(pg, s), rtol=1e-6)
            elif prog.name == "wcc":
                np.testing.assert_array_equal(dist[i], reference_wcc(pg))
            else:
                np.testing.assert_allclose(
                    dist[i], reference_pagerank(pg, prog.damping, prog.superstep_budget),
                    rtol=1e-5, atol=1e-9,
                )
        checked[prog.name] = list(dist.shape)
    return {"n_vertices": g.n_vertices, "n_edges": g.n_edges, "checked": checked}


def _main_path_programs(pg, seed: int):
    rng = np.random.default_rng(seed)
    n = pg.graph.n_vertices
    bfs_sources = [0, *rng.choice(np.arange(1, n), BFS_SOURCES - 1, replace=False).tolist()]
    return (
        ("bfs", BfsProgram(), bfs_sources),
        ("wcc", WccProgram(), [0]),
        ("pagerank", PageRankProgram(num_iters=PAGERANK_ITERS), [0]),
    )


def _pagerank_f64(pg, damping: float, iters: int, device) -> np.ndarray:
    """Plain float64 power iteration on the card (``index_add_``), the
    same fixed-budget update as ``PageRankProgram``: the exact reference
    both backends' float32 states are held against."""
    g = pg.graph
    n = g.n_vertices
    src = torch.as_tensor(g.src.astype(np.int64), device=device)
    dst = torch.as_tensor(g.dst.astype(np.int64), device=device)
    inv = 1.0 / torch.as_tensor(np.maximum(g.out_degree, 1), device=device).double()
    contrib_w = inv.index_select(0, src)
    rank = torch.full((n,), 1.0 / n, dtype=torch.float64, device=device)
    for _ in range(iters):
        acc = torch.zeros_like(rank).index_add_(0, dst, rank.index_select(0, src) * contrib_w)
        rank = (1.0 - damping) / n + damping * acc
    return rank.cpu().numpy()


def _max_rel_err(x: np.ndarray, ref: np.ndarray) -> float:
    x, ref = x.astype(np.float64), ref.astype(np.float64)
    return float((np.abs(x - ref) / np.maximum(np.abs(ref), 1e-30)).max())


def _run(pg, prog, sources, cfg):
    """One traversal through ``bsp.run_program``, timed on the host clock
    around work that ends in the pull to the host."""
    t0 = time.perf_counter()
    dist, traces = bsp.run_program(
        pg, prog, sources, max_supersteps=MAX_SUPERSTEPS, collect_subgraphs=False,
        config=cfg,
    )
    torch.cuda.synchronize()
    return dist, traces, time.perf_counter() - t0


def phase_slice(pg, device, seed: int) -> tuple[dict, dict]:
    cfg = EngineConfig(device=str(device), backend="cuda")
    engine_cfg = cfg.replace(m_max=MAX_SUPERSTEPS, collect_subgraphs=False)
    programs = _main_path_programs(pg, seed)
    engines, setup_s = {}, {}
    for name, prog, _ in programs:  # engine set-up: uploads + row offsets
        t0 = time.perf_counter()
        engines[name] = get_engine(pg, program=prog, config=engine_cfg)
        torch.cuda.synchronize()
        setup_s[name] = time.perf_counter() - t0

    # -- the main path, with every launch count at 0 just before it --------
    relax_rowptr.launches = 0
    relax_rowptr.variant_launches = dict.fromkeys(VARIANTS, 0)
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, prog, sources in programs:
        syncs0, launches0 = engines[name].host_syncs, relax_rowptr.launches
        dist, traces, secs = _run(pg, prog, sources, cfg)
        runs[name] = {
            "dist": dist, "traces": traces, "seconds": secs,
            "host_syncs": engines[name].host_syncs - syncs0,
            "launches": relax_rowptr.launches - launches0,
        }
    launches = relax_rowptr.launches
    variant_launches = dict(relax_rowptr.variant_launches)
    peak_bytes = torch.cuda.max_memory_allocated()
    # -- end of the main path ----------------------------------------------
    _check(launches > 0, "the main path launched the relax kernel no time")
    for variant, _, _, prog in MAIN_VARIANTS:
        _check(variant_launches[variant] > 0, f"{variant} ({prog}) was never launched")

    report = {}
    plain_cfg = cfg.replace(backend="torch")
    for name, prog, sources in programs:
        run = runs[name]
        _, _, warm_s = _run(pg, prog, sources, cfg)
        get_engine(pg, program=prog, config=engine_cfg.replace(backend="torch"))
        plain_dist, plain_traces, plain_s = _run(pg, prog, sources, plain_cfg)
        if name == "pagerank":
            exact = _pagerank_f64(pg, prog.damping, prog.superstep_budget, device)
            pagerank_err = {
                "cuda": _max_rel_err(run["dist"][0], exact),
                "torch": _max_rel_err(plain_dist[0], exact),
                "cuda_vs_torch": _max_rel_err(run["dist"][0], plain_dist[0]),
            }
            np.testing.assert_allclose(
                run["dist"][0], exact, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL
            )
            np.testing.assert_allclose(
                run["dist"], plain_dist, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL
            )
        else:
            np.testing.assert_array_equal(run["dist"], plain_dist)
        for t_k, t_p in zip(run["traces"], plain_traces):
            for field in ("active", "edges_examined", "verts_processed", "msgs_sent",
                          "inner_iters"):
                np.testing.assert_array_equal(getattr(t_k, field), getattr(t_p, field))
        report[name] = {
            "S": len(sources),
            "supersteps": [t.n_supersteps for t in run["traces"]],
            "inner_iters": [int(t.inner_iters.sum()) for t in run["traces"]],
            "kernel_launches": run["launches"],
            "host_syncs": run["host_syncs"],
            "engine_setup_s": setup_s[name],
            "cuda_s": run["seconds"],
            "cuda_warm_s": warm_s,
            "torch_backend_s": plain_s,
        }

    # -- the output is right by the repo's own means ------------------------
    n = pg.graph.n_vertices
    bfs = runs["bfs"]["dist"]
    row_ptr, col, _ = pg.graph.csr
    hops = _bfs_hops(row_ptr, col, n, 0)
    np.testing.assert_array_equal(bfs[0], hops.astype(np.float32))
    _check(bfs.shape == (BFS_SOURCES, n) and np.isfinite(bfs).all(),
           "BFS left vertices unreached on a connected graph")
    wcc = runs["wcc"]["dist"]
    _check(wcc.dtype == np.int32 and (wcc == 0).all(),
           "WCC labels of the connected graph are not all 0")
    pr = runs["pagerank"]["dist"]
    _check(pr.dtype == np.float32 and np.isfinite(pr).all() and (pr > 0).all(),
           "PageRank is not finite and positive")
    _check(abs(float(pr.sum(dtype=np.float64)) - 1.0) < 1e-3,
           f"PageRank mass {float(pr.sum(dtype=np.float64))} is not 1")

    summary = {
        "programs": report,
        "kernel_launches": launches,
        "variant_launches": variant_launches,
        "peak_device_bytes": peak_bytes,
        "bfs_source0_matches_host_bfs": True,
        "pagerank_max_rel_err": pagerank_err,
    }
    return summary, runs


def phase_pipeline(pg, trace) -> dict:
    tf = TimeFunction.from_trace(trace).scaled_to_tmin(LIVJ_T_MIN_S)
    model = BillingModel(delta=BILLING_DELTA_S)
    table = []
    for name, strategy in STRATEGIES.items():
        r = evaluate(strategy(tf), model)
        _check(np.isfinite(r.makespan) and r.makespan >= tf.t_min() * (1 - 1e-9),
               f"{name}: makespan {r.makespan} below T_Min {tf.t_min()}")
        _check(r.cost_quanta >= 1, f"{name}: no quanta billed")
        table.append({
            "strategy": name, "makespan_s": r.makespan,
            "makespan_over_tmin": r.makespan_over_tmin, "cost_quanta": r.cost_quanta,
            "core_secs": r.core_secs, "peak_vms": r.peak_vms,
        })
    t0 = time.perf_counter()
    n_subgraphs = pg.n_subgraphs
    t1 = time.perf_counter()
    pred_tf, sched = predict_time_function(pg, 0)
    t2 = time.perf_counter()
    _check(sched.n_supersteps > 0 and np.isfinite(pred_tf.tau).all(),
           "the metagraph predicted no supersteps")
    return {
        "t_min_s": tf.t_min(), "supersteps": tf.n_supersteps,
        "cost_table": table,
        "n_subgraphs": n_subgraphs, "subgraphs_s": t1 - t0,
        "predicted_supersteps": sched.n_supersteps, "predict_s": t2 - t1,
    }


def phase_profile(pg, device, seed: int) -> dict:
    """One warm BFS traversal under ``torch.profiler``: the card's busy
    share of the traversal's wall time, the relax kernel's share of the
    busy time, and the kernels that take the most device time.  The
    profiler's own overhead lengthens the wall time, so the busy share is
    a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, prog, sources = _main_path_programs(pg, seed)[0]
    cfg = EngineConfig(device=str(device), backend="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, secs = _run(pg, prog, sources, cfg)
    by_name = {}  # device activity (kernels, copies) -> [ms, count]
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            slot = by_name.setdefault(ev.name, [0.0, 0])
            slot[0] += ev.time_range.elapsed_us() / 1e3
            slot[1] += 1
    rows = [(k, ms, c) for k, (ms, c) in by_name.items()]
    busy_ms = sum(r[1] for r in rows)
    relax_ms = sum(r[1] for r in rows if "relax_rowptr_kernel" in r[0])
    rows.sort(key=lambda r: -r[1])
    return {
        "program": prog.name, "S": len(sources), "wall_ms": secs * 1e3,
        "device_busy_ms": busy_ms, "busy_share": busy_ms / (secs * 1e3),
        "relax_kernel_ms": relax_ms,
        "top": [{"name": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:12]],
    }


def kernels_line(checks: dict, variant_launches: dict) -> dict:
    """One entry per kernel the main path launched, with its numbers at the
    main path's own shape (the local closure's reduction)."""
    entries = []
    for variant, _, _, prog in MAIN_VARIANTS:
        cases = checks[variant]
        main = cases[0]
        entries.append({
            "name": f"relax_rowptr_kernel<{variant}>",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": variant_launches[variant],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "program": prog,
            "shape": {"S": main["S"], "n": main["n"], "E": main["E"]},
            "held_against": [c["case"] for c in cases],
        })
    return {"kernels": entries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22, help="R-MAT scale (2**scale vertices)")
    ap.add_argument("--seed", type=int, default=0, help="seeds inputs and BFS sources")
    ap.add_argument("--out", default=None, help="also write the full report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs the port on an "
              "NVIDIA card and reports nothing without one", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    report = {}

    report["device"] = phase_device()
    _emit("device", report["device"])
    pg, report["graph"] = build_graph(args.scale, LIVJ_PARTS)
    _emit("graph", report["graph"])
    checks = phase_kernels(pg, args.seed, device)
    report["kernel"] = checks
    _emit("kernel", {"variants": checks})
    report["oracle"] = phase_oracles(device, args.seed)
    _emit("oracle", report["oracle"])
    report["slice"], runs = phase_slice(pg, device, args.seed)
    _emit("slice", report["slice"])
    report["pipeline"] = phase_pipeline(pg, runs["bfs"]["traces"][0])
    _emit("pipeline", report["pipeline"])
    report["profile"] = phase_profile(pg, device, args.seed)
    _emit("profile", report["profile"])
    report["kernels"] = kernels_line(checks, report["slice"]["variant_launches"])["kernels"]
    report["wall_s"] = time.perf_counter() - t_start
    _emit("done", {"wall_s": report["wall_s"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": report["kernels"]}))
    print(report["device"]["nvidia_smi"])
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
