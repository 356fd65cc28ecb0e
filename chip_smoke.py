#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the paper's pipeline once on one NVIDIA card, through the port's own
entry points, at the size of the paper's LiveJournal workload (LIVJ/8P):

  1. device  -- the card's name and power limit; the three kernels' builds,
                one ``nvcc`` each, all started together.
  2. segment_sum -- ``sorted_segment_sum`` at ogbn-products' full size
                (N = 2,449,029, E = 61,859,140, D = 128, float32), ids
                uniform and power-law (zipf 1.5); launch counts set to 0
                just before and read just after.  Held per segment against
                a float64 ``index_add_`` within 1e-6 of the segment's sum
                of |vals|, then small and degenerate cases against the
                plain version; timed beside its bound and ``index_add_``.
  3. flash_attention -- ``flash_attention`` on one Mixtral-8x22B attention
                layer at a 32k prefill (B=1, S=32768, H=48, Hk=8, d=128,
                causal, window 4096, bfloat16) and a causal 8k case (H=32,
                Hk=8); launch counts as above, and the TMA/wgmma kernel
                (``"bfloat16-wgmma"``) must have run.  Held against the
                chunked plain version on the first, a middle and the last
                512 rows, at 2e-2 and at a bound scaled to each row's size
                (a window 64 keys short must fail that bound), then small
                cases (ragged S among them), each naming the kernel it
                took; timed beside its bound and SDPA.
  4. graph   -- ``rmat_graph(22, 8, seed=42)`` (about 4.2 M vertices and
                68 M directed edges, SNAP soc-LiveJournal1's size) split by
                ``bfs_grow_partition(..., 8, seed=1)``; host build times.
  5. segment_sum_livj -- ``sorted_segment_sum`` over that graph's sorted
                destinations (an R-MAT in-degree spread, D = 128), held and
                timed as in phase 2.
  6. kernel  -- the CUDA relax kernel (every template instantiation the
                main path runs) held against its plain PyTorch version at the
                main path's shapes (the local and the remote layout) and at
                the degenerate shapes (no edges, n < 8, one edge), and
                float32 min also at the elastic path's S=1 and the serving
                path's S=8 over both layouts: min bit-exact, sum within
                rtol=1e-5, atol=1e-9.  Times by CUDA
                events, one call at a time and back to back, beside the
                bound and one ``scatter_reduce`` call.  Then
                ``relax_phases``: a diagnosis build of the kernel
                (``RELAX_PHASE_CLOCKS``) splits a block's cycles by phase.
  7. oracle  -- BFS, SSSP, WCC and PageRank on a small graph on the card,
                held against the port's numpy oracles.
  8. slice   -- the main path: BFS from 4 sources, WCC and 20 PageRank
                iterations through ``bsp.run_program`` on the ``cuda``
                backend, with the kernel's launch counts set to 0 just
                before and read just after.  Then the same runs on the
                ``torch`` backend on the same card: state bit-identical for
                BFS and WCC, allclose for PageRank, traces exact.  BFS
                source 0 is held against the host BFS ``_bfs_hops``.
  9. pipeline -- the BFS trace becomes the time function A, scaled to
                LIVJ's T_Min of 21 s; every placement strategy is billed at
                delta = 60 s; ``predict_time_function`` gives the
                metagraph's a-priori plan.
  10. elastic -- the plan executed: ``ElasticBSPExecutor`` runs BFS from
                vertex 0 on LIVJ/8P, 8 supersteps per window, once per
                placement strategy, each planned from the metagraph
                prediction (in the trace's seconds) and re-planned online
                with it as the sketch, plus one FFD run planned from the
                prediction's first 3 supersteps only, which must re-plan;
                launch counts set to 0 just before and read just after.
                Held: state bit-identical to the slice's BFS row; the same
                runs on the ``torch`` backend give the same
                ``ExecutionReport``; one-superstep windows the same state and
                tau with one bulk pull per superstep (+1).  Then a run with
                4,096 seeded edge inserts merged at superstep 4, held against
                ``bsp.run_program`` and the host BFS on the mutated graph
                (which must hold 4,096 more edges), and the
                ``repartition=`` variant (on a cut graph where one
                repartition pass over LIVJ/8P would take over 30 s), which
                must move vertices.
  11. serve  -- ``TraversalService`` answers 64 BFS queries (8 rows a
                batch, 8 supersteps a window): first all at t = 0 on all 8
                VMs, which gives the highest rate mu it sustains, then Poisson
                arrivals at 0.25 mu and 0.9 mu, elastic and static; launch
                counts as above.  Held: every query accounted for, elastic
                no dearer than static, and at 0.9 mu the ``cuda`` and
                ``torch`` backends' reports identical and every completed
                query's state row too, the first 2 also equal to the host
                BFS.
  12. profile -- one more BFS traversal under ``torch.profiler``: the
                card's busy share, the kernels that take its time, and the
                relax reduction's three kernels (partition, reduction,
                fix-up) found by name.
  13. relax_entries -- the two min-only entries (``bfs_relax_csr``,
                ``bfs_relax``) at S=1 over the local edges, each against the
                ``torch`` backend, timed beside the kernel alone.

Each phase prints one JSON line.  Then come the ``{"kernels": [...]}``
line, the card's ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero.  Without CUDA it exits non-zero at once and prints no
result.

    python3 chip_smoke.py                    # the full LIVJ/8P size
    python3 chip_smoke.py --scale 16         # a quick run: a smaller graph,
                                             # fewer edges and a shorter S
    python3 chip_smoke.py --out smoke_report.json    # also keep the full report
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import STRATEGIES, BillingModel, TimeFunction, evaluate  # noqa: E402
from repro_torch.core.elastic import ElasticBSPExecutor  # noqa: E402
from repro_torch.core.metagraph import predict_time_function  # noqa: E402
from repro_torch.core.repartition import (  # noqa: E402
    RepartitionConfig,
    partition_penalty,
)
from repro_torch.graph import EdgeDeltaBuffer, bsp  # noqa: E402
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
from repro_torch.kernels.bfs_relax import ops as relax_ops  # noqa: E402
from repro_torch.kernels.bfs_relax.kernel import (  # noqa: E402
    VARIANTS,
    RelaxKernel,
    relax_rowptr,
    tile_count,
)
from repro_torch.kernels.bfs_relax.ops import (  # noqa: E402
    _identity_scalar,
    layout_edges_on_device,
    layout_index_on_device,
)
from repro_torch.kernels.bfs_relax.ref import relax_reference  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_rows,
    bf16_tolerance_ratio,
    flash_attention,
    flash_fwd,
    reference_attention,
)
from repro_torch.kernels.flash_attention.kernel import variant_for  # noqa: E402
from repro_torch.kernels.segment_sum import (  # noqa: E402
    reference_segment_sum,
    segment_sum_sorted,
    sorted_segment_sum,
)
from repro_torch.serve import ServiceConfig, TraversalService, poisson_trace  # noqa: E402
from repro_torch.serve.batcher import MicroBatcher  # noqa: E402

#: H100 SXM peaks (NVIDIA's data sheet, at the full 700 W power limit):
#: HBM3 bandwidth, the float32 rate outside the tensor cores (the relax
#: kernel's int32 compares are counted at the same rate) and the dense
#: bfloat16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_FLOPS = 989e12

LIVJ_PARTS = 8
LIVJ_T_MIN_S = 21.0  # LIVJ's T_Min in the JAX package's data/workloads.py
BILLING_DELTA_S = 60.0
PAGERANK_ITERS = 20
BFS_SOURCES = 4
MAX_SUPERSTEPS = 256
#: the executor's and the service's supersteps per window (``EngineConfig``
#: and ``ServiceConfig`` defaults); the mutation run takes windows of 4, so
#: its merge at superstep 4 lands on a window boundary before the BFS ends
ELASTIC_WINDOW, MUTATION_WINDOW, MUTATION_STEP = 8, 4, 4
MUTATION_INSERTS = 4096
#: a repartition pass on the full graph is cut to this scale when its
#: projected host time (one penalty per candidate of the default pass)
#: passes REPARTITION_MAX_S.  The cut run scores this many boundary
#: vertices: the default 256 are the R-MAT hubs, whose neighbours mostly
#: share their partition, so random inserts would move none of them
REPARTITION_CUT_SCALE, REPARTITION_MAX_S, REPARTITION_CANDIDATES = 16, 30.0, 16384
SERVE_QUERIES, SERVE_BATCH = 64, 8
#: completed serving queries whose state rows are also held against the host
#: BFS (every completed row is held against the ``torch`` backend's)
SERVE_HOST_CHECKS = 2
#: one elastic run is planned from the prediction's first supersteps only,
#: so the executed BFS outruns its plan and must re-plan
REPLAN_PLAN_STEPS = 3
SERVE_RATE_FRACTIONS = (0.25, 0.9)
#: PageRank's state on the kernel is held against a float64 power iteration
#: on the card.  A sum of positive terms adds no relative error beyond its own
#: roundings, and an iteration rounds at most 7 times in float32 (state,
#: plane, product, two kernel outputs, the update's multiply and add), so
#: after 20 iterations a vertex is within 20 * 7 * 2**-24 = 8.3e-6.
PAGERANK_RTOL, PAGERANK_ATOL = 1e-5, 1e-9

KERNEL_SOURCE = "src/repro_torch/kernels/bfs_relax/csrc/relax.cu"
KERNEL_REPLACES = "src/repro/kernels/bfs_relax/kernel.py:138"
#: the relax reduction's kernels in csrc/relax.cu, as the profiler names them
RELAX_KERNEL_SYMBOLS = ("relax_partition_kernel", "relax_rowptr_kernel", "relax_fixup_kernel")
SEG_SOURCE = "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu"
SEG_REPLACES = "src/repro/kernels/segment_sum/kernel.py:61"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:91"
FULL_SCALE = 22

#: ogbn-products at full size (OGB's published counts): the segment sum's
#: main shape, the workload benchmarks/kernel_bench.py names.
OGBN_PRODUCTS_N, OGBN_PRODUCTS_E, SEG_D = 2_449_029, 61_859_140, 128
#: kernel against a float64 sum, per segment: |err| <= SEG_REL_TOL *
#: sum(|vals|) over the segment.  The JAX tests' 1e-4 is for segments of a
#: few terms; the power-law hub holds about 38% of all edges (23.7 M
#: terms), where any float32 order drifts far more than 1e-4 in absolute
#: terms, so the bound scales with the segment.  The kernel adds runs of at
#: most 128 terms and then those partials level by level; on an H100 at the
#: full size it stood at most 3.7e-7 of sum(|vals|) off float64 (uniform;
#: 2.4e-7 power-law), the float32 ``index_add_`` at 3.5e-7 / 2.8e-7, and
#: the bound leaves 2.7x of room over that.
SEG_REL_TOL = 1e-6
#: kernel against the plain version on the small cases (both float32)
SEG_SMALL_REL_TOL = 1e-5
#: one Mixtral-8x22B attention layer at a 32k prefill
#: (src/repro/configs/mixtral_8x22b.py; benchmarks/kernel_bench.py:47-49
#: unsharded), and the causal 8k case with granite-3-8b's and
#: mistral-nemo-12b's heads
FLASH_MAIN = {"b": 1, "s": 32768, "h": 48, "hk": 8, "d": 128, "causal": True, "window": 4096}
FLASH_CAUSAL = {"b": 1, "s": 8192, "h": 32, "hk": 8, "d": 128, "causal": True, "window": None}
#: the JAX tests' tolerances: bfloat16 2e-2 (held in float32), float32 1e-5.
#: A bfloat16 output is also held to ``bf16_tolerance_ratio`` <= 1 (the
#: bound per element scales with its row: ``flash_attention/ref.py``), since
#: a 4096-key window's outputs are about as small as 2e-2.
FLASH_BF16_TOL, FLASH_F32_TOL = 2e-2, 1e-5
FLASH_CHECK_ROWS = 512
#: the control: the window case run with a window this many keys short
#: (half a 128-key tile) must fail the scaled bound on the rows it changes;
#: it runs where the window is shorter than S (not in a cut run)
FLASH_CONTROL_SHORT = 64
#: the template instantiations the main path runs, and the program each
#: serves there: (variant, reduce, dtype, program name)
MAIN_VARIANTS = (
    ("float32-min", "min", torch.float32, "bfs"),
    ("int32-min", "min", torch.int32, "wcc"),
    ("float32-sum", "sum", torch.float32, "pagerank"),
)
#: the instantiation the elastic path (BFS, S=1) and the serving path (SSSP
#: on unit weights, S = SERVE_BATCH) launch; ``phase_kernels`` also holds it
#: at those two shapes over both layouts
PATH_VARIANT = "float32-min"


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


def _back_to_back_ms(fn, reps: int) -> float:
    """Mean time of ``reps`` calls enqueued back to back between two CUDA
    events, after one warm-up call: the host's per-call work overlaps the
    card's, so a short kernel is not charged the wait for its own launch."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


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


KERNELS = {"relax": relax_rowptr, "segment_sum": segment_sum_sorted, "flash_attention": flash_fwd}
#: a diagnosis build of the relax kernel that records its phase clocks
#: (``RELAX_PHASE_CLOCKS`` in csrc/relax.cu); never on the main path
RELAX_PHASE_KERNEL = RelaxKernel(defines=("RELAX_PHASE_CLOCKS",))
#: the spans between relax_rowptr_kernel's phase marks, in order
RELAX_PHASES = ("prologue loads", "per-thread search", "stage source 0", "walk + warp scan",
                "block scan + first rows", "output, later sources")


def phase_device() -> dict:
    """The card, and the three kernels' builds: one ``nvcc`` per source,
    all started together."""
    smi = _nvidia_smi()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        for fut in [pool.submit(k.load) for k in (*KERNELS.values(), RELAX_PHASE_KERNEL)]:
            fut.result()
    build_s = time.perf_counter() - t0
    return {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernel_build_s": build_s,
        "kernel_build_s_each": {name: k.build_seconds for name, k in KERNELS.items()},
        "ptxas": {
            name: [line.strip() for line in k.build_log.splitlines()
                   if "registers" in line or "spill" in line]
            for name, k in KERNELS.items()
        },
    }


def _cut(scale: int) -> int:
    """How many halvings a ``--scale`` below the full size asks for."""
    return max(0, FULL_SCALE - scale)


def _library_ms(fn, reps: int) -> tuple[float | None, str]:
    """A yardstick's time, or None and the reason it could not run."""
    try:
        return _median_ms(fn, reps), "ran"
    except (RuntimeError, ValueError) as exc:  # the yardstick only, never a check
        torch.cuda.empty_cache()
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"


# -- segment sum ---------------------------------------------------------------


def _seg_bound(e: int, n: int, d: int, val_bytes: int, id_bytes: int) -> tuple[float, str]:
    """Each value and id read once, each output written once; one add per
    value."""
    t_bytes = (val_bytes * e * d + id_bytes * e + 4 * n * d) / HBM_BYTES_PER_S * 1e3
    t_ops = e * d / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _seg_ids(rng, e: int, n: int, skew: str, device) -> torch.Tensor:
    """Seeded ids drawn on the host as tests/test_kernels.py draws them,
    sorted on the card, int32."""
    raw = rng.zipf(1.5, e) % n if skew == "powerlaw" else rng.integers(0, n, e)
    ids = torch.as_tensor(raw.astype(np.int32), device=device)
    return ids.sort().values


def _seg_against_f64(out, ids, vals, n, chunk=1 << 21) -> dict:
    """The kernel's and the float32 plain version's error per segment
    against a float64 ``index_add_`` over edge chunks, as a share of the
    segment's sum of |vals|."""
    ref = torch.zeros((n, vals.shape[1]), dtype=torch.float64, device=vals.device)
    mag = torch.zeros_like(ref)
    for c0 in range(0, ids.shape[0], chunk):
        idx = ids[c0:c0 + chunk].long()
        x = vals[c0:c0 + chunk].double()
        ref.index_add_(0, idx, x)
        mag.index_add_(0, idx, x.abs_())
        del x
    plain = reference_segment_sum(ids, vals, n)
    res = {}
    for name, t in (("kernel", out), ("plain_f32", plain)):
        err = (t.double() - ref).abs_()
        excess = float((err - SEG_REL_TOL * mag).max())
        share = float((err / mag.clamp_min(1e-300)).max())
        res[name] = {"max_abs_err": float(err.max()), "max_err_over_abs_sum": share,
                     "within_tol": excess <= 0.0}
        del err
    res["kernel_vs_plain_max_abs_err"] = _max_abs_err(out, plain)
    del ref, mag, plain
    return res


def _seg_small_cases(device, seed: int) -> list[dict]:
    """Degenerate and odd shapes, held against the plain version on the
    card: per segment |err| <= SEG_SMALL_REL_TOL * sum(|vals|)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    cases = (
        # name, E, N, D, vals dtype, skew, ids dtype, sorted
        ("e0", 0, 64, 16, torch.float32, "uniform", torch.int32, True),
        ("n_lt_8", 50, 5, 16, torch.float32, "uniform", torch.int32, True),
        ("single_edge", 1, 40, 16, torch.float32, "uniform", torch.int32, True),
        ("d10", 20_000, 900, 10, torch.float32, "uniform", torch.int32, True),
        ("d33", 20_000, 900, 33, torch.float32, "powerlaw", torch.int64, True),
        ("d75", 20_000, 900, 75, torch.float32, "powerlaw", torch.int32, True),
        ("bf16", 20_000, 900, 64, torch.bfloat16, "uniform", torch.int32, True),
        ("ids_out_of_range", 20_000, 900, 32, torch.float32, "out_of_range", torch.int32, True),
        ("unsorted", 20_000, 900, 32, torch.float32, "powerlaw", torch.int32, False),
        ("hub_levels", 2_000_000, 5000, 48, torch.float32, "powerlaw", torch.int32, True),
    )
    out = []
    for name, e, n, d, vdt, skew, idt, is_sorted in cases:
        if skew == "out_of_range":
            raw = np.sort(rng.integers(-7, n + 7, e))
        else:
            raw = np.sort(rng.zipf(1.5, e) % n if skew == "powerlaw" else rng.integers(0, n, e))
        ids = torch.as_tensor(raw, device=device).to(idt)
        vals = torch.randn((e, d), generator=gen, device=device).to(vdt)
        if not is_sorted:
            perm = torch.randperm(e, generator=gen, device=device)
            ids, vals = ids[perm], vals[perm]
        got = sorted_segment_sum(ids, vals, n, assume_sorted=is_sorted)
        ref = reference_segment_sum(ids, vals, n)
        mag = reference_segment_sum(ids, vals.float().abs(), n)
        torch.cuda.synchronize()
        _check(got.shape == (n, d) and got.dtype == torch.float32,
               f"segment sum {name}: shape {tuple(got.shape)} {got.dtype}")
        err = (got - ref).abs()
        _check(bool((err <= SEG_SMALL_REL_TOL * mag).all()),
               f"segment sum {name} disagrees with the plain version (max abs err "
               f"{float(err.max()) if err.numel() else 0.0})")
        out.append({"case": name, "E": e, "N": n, "D": d, "vals": str(vdt)[6:],
                    "ids": str(idt)[6:], "max_abs_err": _max_abs_err(got, ref)})
    return out


def _seg_case(name: str, out, ids, vals, n: int) -> dict:
    """One main-shape call's output held against float64, then the entry
    point, the plain version and ``index_add_`` timed on the same inputs."""
    e, d = vals.shape
    _check(out.shape == (n, d) and out.dtype == torch.float32
           and bool(torch.isfinite(out).all()),
           f"segment sum {name}: not finite float32 [N, D]")
    held = _seg_against_f64(out, ids, vals, n)
    _check(held["kernel"]["within_tol"],
           f"segment sum {name}: kernel off float64 by more than {SEG_REL_TOL} of a "
           f"segment's sum of |vals| ({held['kernel']['max_err_over_abs_sum']})")
    del out
    largest = int(torch.bincount(ids, minlength=n).max())
    ids_long = ids.long()
    lib_out = torch.zeros((n, d), dtype=torch.float32, device=vals.device)
    bound_ms, bound_by = _seg_bound(e, n, d, 4, 4)
    lib_ms, lib_note = _library_ms(lambda: lib_out.index_add_(0, ids_long, vals), 5)
    del ids_long, lib_out
    return {
        "case": name, "E": e, "N": n, "D": d,
        "largest_segment": largest,
        "max_abs_err": held["kernel_vs_plain_max_abs_err"],
        "against_float64": held,
        "ms": _median_ms(lambda: sorted_segment_sum(ids, vals, n, assume_sorted=True), 5),
        "plain_ms": _median_ms(lambda: reference_segment_sum(ids, vals, n), 5),
        "library_ms": lib_ms, "library": "Tensor.index_add_ (float32)",
        "library_note": lib_note,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def phase_segment_sum(device, seed: int, scale: int) -> dict:
    """``sorted_segment_sum`` at ogbn-products' full size (E cut by
    ``2**(22 - scale)`` below the full scale), uniform and power-law ids."""
    e = OGBN_PRODUCTS_E >> _cut(scale)
    n, d = OGBN_PRODUCTS_N, SEG_D
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    vals = torch.randn((e, d), generator=gen, device=device)  # 31.7 GB at full size
    rng = np.random.default_rng(seed)
    skews = ("uniform", "powerlaw")
    ids = {skew: _seg_ids(rng, e, n, skew, device) for skew in skews}
    torch.cuda.synchronize()

    # -- the entry point's calls, with the launch count at 0 just before --
    segment_sum_sorted.launches = 0
    torch.cuda.reset_peak_memory_stats()
    outs = {skew: sorted_segment_sum(ids[skew], vals, n, assume_sorted=True) for skew in skews}
    torch.cuda.synchronize()
    launches = segment_sum_sorted.launches
    peak = torch.cuda.max_memory_allocated()
    # -- end of the entry point's calls --
    _check(launches > 0, "sorted_segment_sum launched its kernel no time")

    cases = [_seg_case(skew, outs.pop(skew), ids[skew], vals, n) for skew in skews]
    del vals, ids
    torch.cuda.empty_cache()
    small = _seg_small_cases(device, seed)
    torch.cuda.empty_cache()
    return {
        "shape": {"E": e, "N": n, "D": d, "dtype": "float32", "ids": "int32"},
        "cut": _cut(scale) > 0,
        "launches": launches,
        "peak_device_bytes": peak,
        "rel_tol_vs_float64": SEG_REL_TOL,
        "cases": cases,
        "small": small,
    }


def phase_segment_sum_livj(pg, device, seed: int) -> dict:
    """``sorted_segment_sum`` over the LIVJ graph's destinations, sorted:
    one segment per vertex, one D = 128 float32 row per edge.  The ids of
    phase 2 are synthetic; these carry an R-MAT graph's in-degree spread."""
    g = pg.graph
    n, e, d = g.n_vertices, g.n_edges, SEG_D
    ids = torch.as_tensor(g.dst.astype(np.int32), device=device).sort().values
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 2)
    vals = torch.randn((e, d), generator=gen, device=device)
    torch.cuda.synchronize()

    # -- the entry point's call, with the launch count at 0 just before --
    segment_sum_sorted.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = sorted_segment_sum(ids, vals, n, assume_sorted=True)
    torch.cuda.synchronize()
    launches = segment_sum_sorted.launches
    peak = torch.cuda.max_memory_allocated()
    # -- end of the entry point's call --
    _check(launches > 0, "sorted_segment_sum launched its kernel no time (LIVJ ids)")
    case = _seg_case("livj_dst", out, ids, vals, n)
    del out, ids, vals
    torch.cuda.empty_cache()
    return {
        "shape": {"E": e, "N": n, "D": d, "dtype": "float32", "ids": "int32"},
        "launches": launches,
        "peak_device_bytes": peak,
        "rel_tol_vs_float64": SEG_REL_TOL,
        "cases": [case],
    }


# -- flash attention -------------------------------------------------------


def _mask_pairs(s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs inside the mask, counted row by row."""
    rows = np.arange(s, dtype=np.int64)
    lo = np.maximum(0, rows - window + 1) if window else np.zeros_like(rows)
    hi = rows + 1 if causal else np.full_like(rows, s)
    return int((hi - lo).sum())


def _flash_bound(cfg: dict, elt: int) -> tuple[float, str, int]:
    """QK^T and PV over the pairs inside the mask (2 FLOP per multiply-add)
    at the bfloat16 tensor-core rate; q, k, v read and o written once."""
    b, s, h, hk, d = cfg["b"], cfg["s"], cfg["h"], cfg["hk"], cfg["d"]
    pairs = _mask_pairs(s, cfg["causal"], cfg["window"])
    flops = 4 * b * h * d * pairs
    t_ops = flops / BF16_TC_FLOPS * 1e3
    t_bytes = elt * b * s * d * (2 * h + 2 * hk) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), pairs


def _qkv(gen, cfg: dict, dtype, device):
    b, s, h, hk, d = cfg["b"], cfg["s"], cfg["h"], cfg["hk"], cfg["d"]
    return tuple(
        torch.randn(shape, generator=gen, device=device).to(dtype)
        for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))
    )


def _sdpa_ms(q, k, v, cfg: dict) -> tuple[float | None, str]:
    """One ``scaled_dot_product_attention`` call on the same inputs, as a
    yardstick: the flash backend with GQA for the causal case; for a
    window, the memory-efficient backend with an explicit boolean mask and
    the kv heads repeated (that backend takes a mask but not GQA)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    g = cfg["h"] // cfg["hk"]
    qt = q.transpose(1, 2)
    if cfg["window"] is None:
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)

        def call():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                return sdpa(qt, kt, vt, is_causal=cfg["causal"], enable_gqa=True)

        ms, note = _library_ms(call, 5)
        return ms, f"SDPA flash backend, is_causal, enable_gqa: {note}"
    s, w = cfg["s"], cfg["window"]
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    i = torch.arange(s, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return sdpa(qt, kt, vt, attn_mask=mask)

    ms, note = _library_ms(call, 5)
    return ms, f"SDPA memory-efficient backend, boolean window mask, kv heads repeated: {note}"


def _flash_variant(q, k, v) -> str:
    """The kernel ``flash_attention`` picks for these inputs."""
    return variant_for(q.shape[-1], q.dtype, all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def _flash_small_cases(device, seed: int) -> list[dict]:
    """tests/test_kernels.py's FLASH_CASES, MQA, ragged non-causal S, an
    odd head dimension; each against the plain version on the card."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    cases = (
        # b, s, h, hk, d, causal, window, dtype
        (2, 256, 4, 2, 64, True, None, torch.float32),
        (1, 128, 2, 2, 128, True, None, torch.float32),
        (2, 256, 4, 4, 64, True, 64, torch.float32),
        (1, 160, 2, 1, 48, True, None, torch.float32),
        (1, 512, 8, 2, 64, True, 128, torch.float32),
        (2, 256, 4, 2, 64, True, None, torch.bfloat16),
        (1, 384, 6, 3, 96, True, None, torch.bfloat16),
        (1, 128, 2, 2, 64, False, None, torch.float32),
        (1, 2048, 16, 1, 128, True, None, torch.bfloat16),  # MQA
        (1, 160, 2, 1, 64, False, None, torch.float32),  # ragged, non-causal
        (1, 200, 2, 1, 64, False, 64, torch.float32),
        (1, 160, 2, 1, 64, False, None, torch.bfloat16),
        (1, 130, 2, 2, 33, True, None, torch.bfloat16),  # odd d: unvectorised loads
        # bfloat16 windows that cut key tiles (64 keys) mid-tile
        (1, 1000, 8, 2, 128, True, 200, torch.bfloat16),
        (2, 700, 6, 3, 96, True, 65, torch.bfloat16),
        (1, 333, 4, 2, 64, False, 100, torch.bfloat16),
        # S not a multiple of the wgmma kernel's 128-row tiles; d = 40 pads
        # to 64 in shared memory
        (2, 333, 4, 2, 64, True, None, torch.bfloat16),
        (1, 200, 4, 1, 128, False, None, torch.bfloat16),
        (1, 129, 2, 1, 40, True, 50, torch.bfloat16),
        (1, 1100, 4, 2, 96, False, 300, torch.bfloat16),
    )
    out = []
    for b, s, h, hk, d, causal, window, dtype in cases:
        cfg = {"b": b, "s": s, "h": h, "hk": hk, "d": d}
        q, k, v = _qkv(gen, cfg, dtype, device)
        got = flash_attention(q, k, v, causal=causal, window=window)
        ref = reference_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
        err = _max_abs_err(got.float(), ref.float())
        ratio = None
        if dtype == torch.bfloat16:
            ratio = bf16_tolerance_ratio(got, attention_rows(
                q, k, v, 0, s, causal=causal, window=window))
        _check(got.dtype == dtype and got.shape == q.shape
               and torch.allclose(got.float(), ref.float(), atol=tol, rtol=tol)
               and (ratio is None or ratio <= 1.0),
               f"flash {cfg} causal={causal} window={window} {dtype} disagrees "
               f"(max abs err {err}, scaled bound ratio {ratio})")
        out.append({**cfg, "causal": causal, "window": window, "dtype": str(dtype)[6:],
                    "variant": _flash_variant(q, k, v), "tol": tol, "max_abs_err": err,
                    "tol_ratio": ratio})
    return out


def phase_flash(device, seed: int, scale: int) -> dict:
    """``flash_attention`` at the Mixtral-8x22B 32k prefill and the causal
    8k case (S cut below the full scale)."""
    cut = _cut(scale)
    mains = {
        name: {**cfg, "s": max(4 * FLASH_CHECK_ROWS, cfg["s"] >> cut)}
        for name, cfg in (("mixtral_32k_window", FLASH_MAIN), ("causal_8k", FLASH_CAUSAL))
    }
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    inputs = {name: _qkv(gen, cfg, torch.bfloat16, device) for name, cfg in mains.items()}
    torch.cuda.synchronize()

    # -- the entry point's calls, with the launch counts at 0 just before --
    flash_fwd.launches = 0
    flash_fwd.variant_launches = dict.fromkeys(flash_fwd.variant_launches, 0)
    torch.cuda.reset_peak_memory_stats()
    outs = {
        name: flash_attention(*inputs[name], causal=cfg["causal"], window=cfg["window"])
        for name, cfg in mains.items()
    }
    torch.cuda.synchronize()
    launches = flash_fwd.launches
    variant_launches = dict(flash_fwd.variant_launches)
    peak = torch.cuda.max_memory_allocated()
    # -- end of the entry point's calls --
    _check(launches > 0 and variant_launches["bfloat16-wgmma"] > 0,
           "flash_attention launched its bfloat16 TMA/wgmma kernel no time")

    cases = []
    for name, cfg in mains.items():
        q, k, v = inputs[name]
        out = outs[name]
        s = cfg["s"]
        _check(out.shape == q.shape and out.dtype == torch.bfloat16
               and bool(torch.isfinite(out).all()), f"flash {name}: not finite bf16 [B,S,H,d]")
        control = None
        if cfg["window"] is not None and cfg["window"] < s:  # the same call, a window short
            control = flash_attention(q, k, v, causal=cfg["causal"],
                                      window=cfg["window"] - FLASH_CONTROL_SHORT)
        errs = []
        for r0 in (0, s // 2 - FLASH_CHECK_ROWS // 2, s - FLASH_CHECK_ROWS):
            r1 = r0 + FLASH_CHECK_ROWS
            ref = attention_rows(q, k, v, r0, r1, causal=cfg["causal"], window=cfg["window"])
            got = out[:, r0:r1]
            err = _max_abs_err(got.float(), ref)
            ratio = bf16_tolerance_ratio(got, ref)
            _check(torch.allclose(got.float(), ref, atol=FLASH_BF16_TOL, rtol=FLASH_BF16_TOL)
                   and ratio <= 1.0,
                   f"flash {name} rows [{r0}, {r1}) disagree with the plain version "
                   f"(max abs err {err}, scaled bound ratio {ratio})")
            row = {"rows": [r0, r1], "max_abs_err": err, "tol_ratio": ratio,
                   "ref_rms": float(ref.square().mean().sqrt())}
            if control is not None:
                row["control_max_abs_err"] = _max_abs_err(control[:, r0:r1].float(), ref)
                row["control_tol_ratio"] = bf16_tolerance_ratio(control[:, r0:r1], ref)
            errs.append(row)
            del ref, got
        if control is not None:
            # rows past the shortened window change; the bound must see it
            _check(max(r["control_tol_ratio"] for r in errs) > 1.0,
                   f"flash {name}: a window {FLASH_CONTROL_SHORT} keys short passes the "
                   f"scaled bound ({[r['control_tol_ratio'] for r in errs]})")
            del control
        bound_ms, bound_by, pairs = _flash_bound(cfg, 2)
        lib_ms, lib_note = _sdpa_ms(q, k, v, cfg)
        cases.append({
            "case": name, "shape": cfg, "dtype": "bfloat16", "pairs": pairs,
            "variant": _flash_variant(q, k, v),
            "max_abs_err": max(x["max_abs_err"] for x in errs), "checked_rows": errs,
            "ms": _median_ms(
                lambda: flash_attention(q, k, v, causal=cfg["causal"], window=cfg["window"]), 5),
            "plain_ms": _median_ms(
                lambda: reference_attention(q, k, v, causal=cfg["causal"], window=cfg["window"]),
                2),
            "library_ms": lib_ms, "library": lib_note,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        torch.cuda.empty_cache()
    del outs, inputs
    torch.cuda.empty_cache()
    small = _flash_small_cases(device, seed)
    return {
        "cut": cut > 0,
        "launches": launches,
        "variant_launches": variant_launches,
        "peak_device_bytes": peak,
        "tol": FLASH_BF16_TOL,
        "scaled_bound": "bf16_tolerance_ratio <= 1 (flash_attention/ref.py)",
        "cases": cases,
        "small": small,
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
        "ms_back_to_back": _back_to_back_ms(
            lambda: relax_rowptr(row_ptr, cand, base, reduce=reduce), 2 * reps),
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
        paths = [("main", s_main, 10)]
        if variant == PATH_VARIANT:
            paths += [("elastic", 1, 5), ("serve", SERVE_BATCH, 5)]
        cases = []
        for path, s, reps in paths:
            for side, lay in (("local", layout.local), ("remote", layout.remote)):
                row_ptr = layout_index_on_device(lay, device, "cuda")
                dst = layout_index_on_device(lay, device, "torch")
                args = _random_case(gen, s, n, lay.n_edges, dtype, reduce, device,
                                    row_ptr=row_ptr, dst=dst)
                name = f"{path}-{side}" + ("" if path == "main" else f"-s{s}")
                cases.append(_hold_case(name, variant, reduce, *args, reps=reps))
                del args
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


def phase_relax_phases(pg, seed: int, device) -> dict:
    """Where relax_rowptr_kernel's time goes: the diagnosis build records
    clock64() at each block's phase boundaries (source 0), at the main
    path's shapes over both layouts; per phase the median cycles over the
    blocks and the share of a block's median life.  Its output is held
    against the plain version like the kernel's."""
    layout = partitioned_edge_layout(pg)
    n = pg.graph.n_vertices
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 4)
    fn = RELAX_PHASE_KERNEL.load().relax_phase_clocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    fn.restype = ctypes.c_int
    out = {}
    for variant, reduce, dtype, prog in MAIN_VARIANTS[:2]:
        s_main = BFS_SOURCES if prog == "bfs" else 1
        for name, lay in (("main-local", layout.local), ("main-remote", layout.remote)):
            row_ptr = layout_index_on_device(lay, device, "cuda")
            dst = layout_index_on_device(lay, device, "torch")
            row_ptr, dst, cand, base = _random_case(gen, s_main, n, lay.n_edges, dtype, reduce,
                                                    device, row_ptr=row_ptr, dst=dst)
            RELAX_PHASE_KERNEL(row_ptr, cand, base, reduce=reduce)  # warm-up
            got = RELAX_PHASE_KERNEL(row_ptr, cand, base, reduce=reduce)
            torch.cuda.synchronize()
            _check(torch.equal(got, relax_reference(dst, cand, base, reduce)),
                   f"{variant} {name}: the phase-clock build disagrees with the plain version")
            tiles = tile_count(n, lay.n_edges)
            marks = np.zeros((min(tiles, 1 << 16), len(RELAX_PHASES) + 1), dtype=np.int64)
            _check(fn(marks.ctypes.data, tiles) == 0, "reading the relax phase clocks failed")
            spans = np.diff(marks, axis=1)
            life = float(np.median(marks[:, -1] - marks[:, 0]))
            out[f"{variant} {name}"] = {
                "S": s_main, "blocks": int(marks.shape[0]), "median_block_cycles": life,
                "median_cycles": dict(zip(RELAX_PHASES, np.median(spans, axis=0).tolist())),
                "share_of_block": dict(zip(RELAX_PHASES,
                                           (np.median(spans, axis=0) / life).tolist())),
            }
            del cand, base, got
    torch.cuda.empty_cache()
    return out


def phase_relax_entries(pg, seed: int, device) -> dict:
    """The two min-only entries that stood on the TPU's
    ``bfs_relax_kernel_blockmap`` (``bfs_relax_csr``, dst-sorted layout)
    and ``bfs_relax_kernel`` (``bfs_relax``, edges in any order, argsorted
    by destination outside the kernel), at S=1 float32 min over the local
    edges: the kernel alone beside its bound and ``scatter_reduce``, then
    each entry on both backends (held bit-identical) with its time.  It
    runs after the main path, so the edges it caches on the layout never
    reach the main path's peak memory."""
    lay = partitioned_edge_layout(pg).local
    n = pg.graph.n_vertices
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)
    row_ptr = layout_index_on_device(lay, device, "cuda")
    dst = layout_index_on_device(lay, device, "torch")
    src, dst32, w = layout_edges_on_device(lay, device)
    dist = torch.rand(n, generator=gen, device=device) * 10.0
    dist[torch.rand(n, generator=gen, device=device) < 0.3] = float("inf")
    frontier = torch.rand(n, generator=gen, device=device) < 0.5
    cand = torch.where(frontier[src.long()], dist[src.long()] + w, float("inf"))[None]
    kernel = _hold_case("main-local-s1", "float32-min", "min", row_ptr, dst,
                        cand.contiguous(), dist[None].contiguous(), reps=10)
    perm = torch.randperm(lay.n_edges, generator=gen, device=device)
    edges = (src[perm], dst32[perm], w[perm])
    routes = {
        "bfs_relax_csr": lambda backend: relax_ops.bfs_relax_csr(
            dist, frontier, lay, backend=backend),
        "bfs_relax": lambda backend: relax_ops.bfs_relax(
            dist, frontier, *edges, backend=backend),
    }
    out = {"kernel_s1": kernel}
    for name, fn in routes.items():
        got, ref = fn("cuda"), fn("torch")
        torch.cuda.synchronize()
        _check(torch.equal(got, ref), f"{name}: cuda and torch backends differ")
        before = relax_rowptr.launches
        fn("cuda")
        out[name] = {
            "launches_per_call": relax_rowptr.launches - before,
            "ms": _median_ms(lambda: fn("cuda"), 10),
            "plain_ms": _median_ms(lambda: fn("torch"), 10),
        }
    out["bfs_relax"]["argsort_ms"] = _median_ms(
        lambda: torch.argsort(edges[1].long(), stable=True), 10)
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
    _zero_launch_counts()
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


def phase_pipeline(pg, trace) -> tuple[dict, TimeFunction]:
    """The trace billed per strategy, and the metagraph's prediction (in
    the engine's unscaled units), which the elastic phase plans from."""
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
    }, pred_tf


def _zero_launch_counts() -> None:
    relax_rowptr.launches = 0
    relax_rowptr.variant_launches = dict.fromkeys(VARIANTS, 0)


def _report_fields(rep) -> dict:
    """An ``ExecutionReport`` as plain comparable values, wall time dropped."""
    out = {k: v for k, v in vars(rep).items() if k != "wall_seconds"}
    out["actual_tau"] = rep.actual_tau.tau
    out["cost"] = dict(vars(rep.cost))
    return out


def _check_reports_equal(a, b, what: str) -> None:
    fa, fb = _report_fields(a), _report_fields(b)
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            same = fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k])
        else:
            same = fa[k] == fb[k]
        _check(same, f"{what}: ExecutionReport.{k} differs")


def _execute(pg, cfg, tau, plan, **run_kw):
    """One ``ElasticBSPExecutor.run`` of BFS from vertex 0, timed on the host
    clock; also the engine's own host reads (loop conditions + pulls, over
    every engine the run used) and the relax kernel's launches in it."""
    ex = ElasticBSPExecutor(pg, program=BfsProgram(), tau_scale=tau, config=cfg)
    first, syncs0, launches0 = ex.engine, ex.engine.host_syncs, relax_rowptr.launches
    t0 = time.perf_counter()
    rep = ex.run(0, plan, **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine_syncs = first.host_syncs - syncs0
    if ex.engine is not first:  # a mutation built the merged graph's engine
        engine_syncs += ex.engine.host_syncs
    return ex, rep, {
        "cost_quanta": rep.cost.cost_quanta,
        "makespan_over_tmin": rep.cost.makespan_over_tmin,
        "migrations": rep.n_migrations, "migration_bytes": rep.migration_bytes,
        "replans": rep.replans, "windows": rep.host_syncs - 1,
        "supersteps": rep.n_supersteps,
        "host_syncs_executor": rep.host_syncs, "host_syncs_engine": engine_syncs,
        "relax_launches": relax_rowptr.launches - launches0,
        "wall_s": wall,
    }


def _insert_buffer(n: int, seed: int) -> EdgeDeltaBuffer:
    rng = np.random.default_rng(seed)
    buf = EdgeDeltaBuffer(capacity=MUTATION_INSERTS)
    buf.insert_many(rng.integers(0, n, MUTATION_INSERTS), rng.integers(0, n, MUTATION_INSERTS))
    return buf


def _mutation_run(pg, cfg, tau, plan, seed: int, repartition, base_row) -> dict:
    """One executor run with the seeded inserts merged at superstep 4, held
    against ``bsp.run_program`` on the mutated graph and against the host
    BFS over the mutated graph's CSR; ``base_row`` is BFS from vertex 0 on
    ``pg`` before the merge."""
    torch.cuda.reset_peak_memory_stats()
    ex, rep, line = _execute(pg, cfg, tau, plan, mutations=[(MUTATION_STEP, _insert_buffer(
        pg.graph.n_vertices, seed))], repartition=repartition)
    line["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    _check(rep.mutations_applied == 1, "the delta buffer was not merged")
    _check(not repartition or rep.repartition_moves > 0, "the repartitioner moved no vertex")
    _check(line["relax_launches"] > 0, "the mutation run launched the relax kernel no time")
    fresh, _ = bsp.run_program(ex.pg, BfsProgram(), [0], max_supersteps=MAX_SUPERSTEPS,
                               config=EngineConfig(device=cfg.device, backend="cuda"))
    _check(np.array_equal(rep.dist, fresh[0]),
           "the mutated run's state differs from a fresh run on the mutated graph")
    g = ex.pg.graph
    _check(g.n_edges == pg.graph.n_edges + MUTATION_INSERTS,
           f"the merged graph holds {g.n_edges} edges, not {pg.graph.n_edges} + "
           f"{MUTATION_INSERTS}")
    row_ptr, col, _ = g.csr
    _check(np.array_equal(rep.dist, _bfs_hops(row_ptr, col, g.n_vertices, 0).astype(np.float32)),
           "the mutated run's state differs from the host BFS on the mutated graph")
    line.update(mutations_applied=rep.mutations_applied,
                repartition_moves=rep.repartition_moves,
                edges_after=ex.pg.graph.n_edges,
                vertices_changed_by_inserts=int((rep.dist != base_row).sum()))
    return line


def phase_elastic(pg, bfs_row, trace, pred_tf, device, seed: int) -> dict:
    """The plan executed window by window (see the module docstring)."""
    tau = LIVJ_T_MIN_S / TimeFunction.from_trace(trace).t_min()
    sketch = TimeFunction(pred_tf.tau * tau)  # the prediction in the trace's seconds
    cfg = EngineConfig(device=str(device), backend="cuda", window=ELASTIC_WINDOW)
    # name -> (plan, strategy); the last plan covers only the prediction's
    # first supersteps, so its run outruns the plan and re-plans
    plans = {name: (strategy(sketch), strategy) for name, strategy in STRATEGIES.items()}
    cut_plan = f"ffd-plan-cut-{REPLAN_PLAN_STEPS}"
    plans[cut_plan] = (STRATEGIES["ffd"](TimeFunction(sketch.tau[:REPLAN_PLAN_STEPS])),
                       STRATEGIES["ffd"])

    def run(name, cfg_):
        plan, strategy = plans[name]
        return _execute(pg, cfg_, tau, plan, strategy_fn=strategy, replan=True, sketch=sketch)

    # -- the path, with every launch count at 0 just before it -------------
    _zero_launch_counts()
    main = {name: run(name, cfg) for name in plans}
    launches, variant_launches = relax_rowptr.launches, dict(relax_rowptr.variant_launches)
    # -- end of the path -----------------------------------------------------
    _check(launches > 0, "the elastic path launched the relax kernel no time")
    _check(main[cut_plan][1].replans > 0, f"{cut_plan}: the run outran its plan but never "
           "re-planned")
    table = {}
    for name, (_, rep, line) in main.items():
        _check(line["relax_launches"] > 0, f"{name}: the run launched the relax kernel no time")
        _check(np.array_equal(rep.dist, bfs_row), f"{name}: state differs from the slice's BFS")
        _, plain, plain_line = run(name, cfg.replace(backend="torch"))
        _check_reports_equal(rep, plain, f"{name} cuda vs torch backend")
        _, step1, step1_line = run(name, cfg.replace(window=1))
        _check(np.array_equal(step1.dist, rep.dist)
               and np.array_equal(step1.actual_tau.tau, rep.actual_tau.tau),
               f"{name}: one-superstep windows changed the state or tau")
        _check(step1.host_syncs == step1.n_supersteps + 1,
               f"{name}: {step1.host_syncs} bulk pulls for {step1.n_supersteps} windows")
        table[name] = {**line, "torch_backend_wall_s": plain_line["wall_s"],
                       "window1": {k: step1_line[k] for k in (
                           "host_syncs_executor", "host_syncs_engine", "wall_s")}}

    mutation = _mutation_run(pg, cfg.replace(window=MUTATION_WINDOW), tau, plans["ffd"][0], seed,
                             repartition=None, base_row=bfs_row)
    torch.cuda.empty_cache()

    # -- repartition= : cut when one pass over the full graph is too slow --
    t0 = time.perf_counter()
    partition_penalty(pg.graph, pg.part_of_vertex)
    penalty_s = time.perf_counter() - t0
    candidates = 4 * RepartitionConfig().max_moves
    cut = penalty_s * candidates > REPARTITION_MAX_S
    rpg = build_graph(REPARTITION_CUT_SCALE, LIVJ_PARTS)[0] if cut else pg
    rrow, rtrace = bsp.run_sssp(rpg, 0, max_supersteps=MAX_SUPERSTEPS, collect_subgraphs=False,
                                config=EngineConfig(device=str(device), backend="cuda"))
    rtf = TimeFunction.from_trace(rtrace)
    t0 = time.perf_counter()
    rcfg = RepartitionConfig(max_candidates=REPARTITION_CANDIDATES)
    repartitioned = _mutation_run(
        rpg, cfg.replace(window=MUTATION_WINDOW), LIVJ_T_MIN_S / rtf.t_min(),
        STRATEGIES["ffd"](rtf.scaled_to_tmin(LIVJ_T_MIN_S)), seed, repartition=rcfg,
        base_row=rrow)
    repartitioned.update(cut=cut, scale=int(np.log2(rpg.graph.n_vertices)),
                         full_graph_penalty_s=penalty_s, default_candidates=candidates,
                         projected_full_pass_s=penalty_s * candidates,
                         candidates=REPARTITION_CANDIDATES, run_s=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return {
        "program": "bfs", "source": 0, "window": ELASTIC_WINDOW, "tau_scale": tau,
        "t_min_s": LIVJ_T_MIN_S, "strategies": table, "plan_cut_run": cut_plan,
        "kernel_launches": launches, "variant_launches": variant_launches,
        "mutation": {"window": MUTATION_WINDOW, "at_superstep": MUTATION_STEP,
                     "inserts": MUTATION_INSERTS, **mutation},
        "repartition": repartitioned,
    }


@contextlib.contextmanager
def _retired_rows(rows: dict):
    """Keep, per query id, the state row its batch row held when it retired
    (a copy on the card).  A row retires when its query completes, or before
    a requeue; the query's last retirement is its completion, so after the
    run ``rows[q.qid]`` is the answer of every completed query ``q``."""
    retire = MicroBatcher.retire

    def keep(self, row):
        rec = retire(self, row)
        rows[rec.qid] = self.state.dist[row].clone()
        return rec

    MicroBatcher.retire = keep
    try:
        yield rows
    finally:
        MicroBatcher.retire = retire


def _serve(pg, trace, cfg: ServiceConfig, ecfg: EngineConfig, rows: dict | None = None):
    """One ``TraversalService.run``: the report and its line, with the lane
    engine's host reads and the relax kernel's launches in it; ``rows``
    also collects the completed queries' state rows (``_retired_rows``)."""
    engine = get_engine(pg, program=SsspProgram(), config=ecfg)
    syncs0, launches0 = engine.host_syncs, relax_rowptr.launches
    splits0 = relax_rowptr.partition_launches
    t0 = time.perf_counter()
    with _retired_rows(rows) if rows is not None else contextlib.nullcontext():
        rep = TraversalService(pg, config=cfg, engine_config=ecfg).run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check(rep.completed + rep.rejected + rep.dropped == rep.offered,
           f"{rep.offered} queries offered, {rep.completed} + {rep.rejected} + "
           f"{rep.dropped} accounted for")
    return rep, {
        "offered": rep.offered, "completed": rep.completed,
        "queries_per_s": rep.queries_per_sec,
        "sojourn_p50_s": rep.sojourn_p50, "sojourn_p99_s": rep.sojourn_p99,
        "occupancy": rep.occupancy, "capacity_mean": rep.capacity_mean,
        "capacity_peak": rep.capacity_peak, "cost_quanta": rep.cost.cost_quanta,
        "cost_per_1k_queries": rep.cost_per_1k_queries, "windows": rep.windows,
        "supersteps": rep.supersteps, "wall_s": wall,
        "wall_s_per_window": wall / max(rep.windows, 1),
        "host_syncs_engine": engine.host_syncs - syncs0,
        "relax_launches": relax_rowptr.launches - launches0,
        "partition_launches": relax_rowptr.partition_launches - splits0,
    }


def phase_serve(pg, trace, device, seed: int) -> dict:
    """A stream of BFS queries served under elastic capacity (see the
    module docstring)."""
    tau = LIVJ_T_MIN_S / TimeFunction.from_trace(trace).t_min()
    cfg = ServiceConfig(s_batch=SERVE_BATCH, window=ELASTIC_WINDOW, tau_scale=tau)
    static_cfg = dataclasses.replace(cfg, static_vms=cfg.max_vms)
    ecfg = EngineConfig(device=str(device), backend="cuda")
    n = pg.graph.n_vertices

    # -- the path, with every launch count at 0 just before it -------------
    _zero_launch_counts()
    _, burst = _serve(pg, poisson_trace(SERVE_QUERIES, 1e9, n, seed=seed), static_cfg, ecfg)
    mu = burst["queries_per_s"]
    frac = SERVE_RATE_FRACTIONS[-1]  # the rate held against the torch backend
    rates, reports, rows = {}, {}, {}
    for f in SERVE_RATE_FRACTIONS:
        trace_f = poisson_trace(SERVE_QUERIES, f * mu, n, seed=seed)
        reports[f], elastic = _serve(pg, trace_f, cfg, ecfg, rows if f == frac else None)
        _, static = _serve(pg, trace_f, static_cfg, ecfg)
        rates[f"{f}mu"] = {"rate_qps": f * mu, "elastic": elastic, "static": static}
    launches, variant_launches = relax_rowptr.launches, dict(relax_rowptr.variant_launches)
    # -- end of the path -----------------------------------------------------
    _check(launches > 0, "the serving path launched the relax kernel no time")
    for key, row in rates.items():
        for mode in ("elastic", "static"):
            _check(row[mode]["relax_launches"] > 0, f"{key} {mode}: no relax launch")
            _check(row[mode]["partition_launches"] == 0,
                   f"{key} {mode}: the relax kernel split a layout again")
        _check(row["elastic"]["cost_quanta"] <= row["static"]["cost_quanta"],
               f"{key}: elastic billed {row['elastic']['cost_quanta']} quanta, static "
               f"{row['static']['cost_quanta']}")
    plain_rows = {}
    plain, plain_line = _serve(pg, poisson_trace(SERVE_QUERIES, frac * mu, n, seed=seed), cfg,
                               ecfg.replace(backend="torch"), plain_rows)
    _check(plain.asdict() == reports[frac].asdict(),
           f"{frac}mu: the cuda and torch backends' ServiceReports differ")
    # the answers: every completed query's state row on both backends, and
    # the first few against the host BFS (SSSP on unit weights = hops)
    done = reports[frac].queries
    _check(len(done) > 0, f"{frac}mu: no query completed")
    for q in done:
        _check(torch.equal(rows[q.qid], plain_rows[q.qid]),
               f"{frac}mu: query {q.qid} (source {q.source}) answered differently on the "
               "cuda and torch backends")
    row_ptr, col, _ = pg.graph.csr
    for q in done[:SERVE_HOST_CHECKS]:
        hops = _bfs_hops(row_ptr, col, n, q.source).astype(np.float32)
        _check(np.array_equal(rows[q.qid].cpu().numpy(), hops),
               f"{frac}mu: query {q.qid} (source {q.source}) differs from the host BFS")
    del rows, plain_rows
    return {
        "program": "sssp", "queries": SERVE_QUERIES, "s_batch": SERVE_BATCH,
        "window": ELASTIC_WINDOW, "tau_scale": tau, "mu_qps": mu, "burst_static": burst,
        "rates": rates, "torch_backend_identical_at": f"{frac}mu",
        "answers_held": {"against_torch_backend": len(done),
                         "against_host_bfs": len(done[:SERVE_HOST_CHECKS])},
        "torch_backend_wall_s": plain_line["wall_s"],
        "kernel_launches": launches, "variant_launches": variant_launches,
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
    # the relax reduction is three kernels: partition, reduction, fix-up
    relax_parts = {
        part: sum(r[1] for r in rows if part in r[0]) for part in RELAX_KERNEL_SYMBOLS
    }
    relax_ms = sum(relax_parts.values())
    _check(relax_parts["relax_rowptr_kernel"] > 0,
           "the profile found no relax_rowptr_kernel in the BFS traversal")
    rows.sort(key=lambda r: -r[1])
    return {
        "program": prog.name, "S": len(sources), "wall_ms": secs * 1e3,
        "device_busy_ms": busy_ms, "busy_share": busy_ms / (secs * 1e3),
        "relax_kernel_ms": relax_ms,
        "relax_kernel_ms_by_part": relax_parts,
        "top": [{"name": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:12]],
    }


def kernels_line(checks: dict, variant_launches: dict, seg: dict, flash: dict,
                 seg_livj: dict, path_launches: dict) -> dict:
    """One entry per kernel the main path launched, with its numbers at the
    main path's own shape: the relax kernel's local closure reduction, the
    segment sum over uniform ids, the flash kernel at the Mixtral 32k
    window (the other cases of each are under ``cases``; the segment sum's
    LIVJ case has its own ``launches`` there).  The relax entries also
    count their launches on the elastic and serving paths
    (``launches_by_path``, each read around its own path)."""
    entries = []
    for variant, _, _, prog in MAIN_VARIANTS:
        cases = checks[variant]
        main, remote = cases[0], cases[1]
        entries.append({
            "name": f"relax_rowptr_kernel<{variant}>",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": variant_launches[variant],
            "launches_by_path": {"slice": variant_launches[variant],
                                 **{p: v[variant] for p, v in path_launches.items()}},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "program": prog,
            "shape": {"S": main["S"], "n": main["n"], "E": main["E"]},
            "ms_back_to_back": main["ms_back_to_back"],
            "main_remote": {k: remote[k] for k in ("S", "n", "E", "ms", "ms_back_to_back",
                                                    "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms")},
            "held_against": [c["case"] for c in cases],
        })
    for name, source, replaces, phase, launches in (
        ("segment_sum_level_kernel", SEG_SOURCE, SEG_REPLACES, seg, seg["launches"]),
        ("flash_fwd_wgmma_kernel", FLASH_SOURCE, FLASH_REPLACES, flash,
         flash["variant_launches"]["bfloat16-wgmma"]),
    ):
        main = phase["cases"][0]
        more = phase["cases"][1:] + (seg_livj["cases"] if phase is seg else [])
        entries.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in [main, *more, *phase["small"]]),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library": main["library"],
            **({"variant": main["variant"]} if "variant" in main else {}),
            "shape": main.get("shape") or {k: main[k] for k in ("E", "N", "D")},
            "case": main["case"],
            "cut": phase["cut"],
            "cases": [{k: c[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")} for c in more],
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

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' float32 products
    report["device"] = phase_device()
    _emit("device", report["device"])
    report["segment_sum"] = phase_segment_sum(device, args.seed, args.scale)
    _emit("segment_sum", report["segment_sum"])
    report["flash_attention"] = phase_flash(device, args.seed, args.scale)
    _emit("flash_attention", report["flash_attention"])
    pg, report["graph"] = build_graph(args.scale, LIVJ_PARTS)
    _emit("graph", report["graph"])
    report["segment_sum_livj"] = phase_segment_sum_livj(pg, device, args.seed)
    _emit("segment_sum_livj", report["segment_sum_livj"])
    checks = phase_kernels(pg, args.seed, device)
    report["kernel"] = checks
    _emit("kernel", {"variants": checks})
    report["relax_phases"] = phase_relax_phases(pg, args.seed, device)
    _emit("relax_phases", report["relax_phases"])
    report["oracle"] = phase_oracles(device, args.seed)
    _emit("oracle", report["oracle"])
    report["slice"], runs = phase_slice(pg, device, args.seed)
    _emit("slice", report["slice"])
    bfs_trace = runs["bfs"]["traces"][0]
    report["pipeline"], pred_tf = phase_pipeline(pg, bfs_trace)
    _emit("pipeline", report["pipeline"])
    report["elastic"] = phase_elastic(pg, runs["bfs"]["dist"][0], bfs_trace, pred_tf, device,
                                      args.seed)
    _emit("elastic", report["elastic"])
    report["serve"] = phase_serve(pg, bfs_trace, device, args.seed)
    _emit("serve", report["serve"])
    report["profile"] = phase_profile(pg, device, args.seed)
    _emit("profile", report["profile"])
    report["relax_entries"] = phase_relax_entries(pg, args.seed, device)
    _emit("relax_entries", report["relax_entries"])
    report["kernels"] = kernels_line(
        checks, report["slice"]["variant_launches"], report["segment_sum"],
        report["flash_attention"], report["segment_sum_livj"],
        {path: report[path]["variant_launches"] for path in ("elastic", "serve")},
    )["kernels"]
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
