"""Time this tree's segment-sum kernel against another tree's, on one card.

    PYTHONPATH=src python -m repro_torch.kernels.segment_sum.compare \\
        --other _archive/parent [--other ...] [--pna] [--livj] \\
        [--out seg_compare.json]

``--other`` is the root of another checkout of the repository (for example
a ``git archive`` of the parent commit), and may be given more than once.
Its launch wrapper is loaded from its own
``src/repro_torch/kernels/segment_sum/kernel.py`` (which shares this tree's
``kernels/build.py`` interface) and builds its own source.  For every shape
in ``SHAPES`` the kernels sum the same inputs through their launch wrappers
in turns (the others, this, this, the others in reverse; each named by its
directory); each turn is the median of
``--reps`` single calls between CUDA events, after one warm-up call.  Both
outputs are held per segment against the plain version (``ref.py``), within
1e-5 of the segment's sum of |vals|.  Beside them: the bound (each value
and id read once, each output written once, at 3.35 TB/s), the plain
version's time, one ``index_add_`` and each wrapper's host time to enqueue
a call (``<name>_host_us``, median of 20, each call synchronised after).  ``--livj`` adds the destinations of
``rmat_graph(22, 8, seed=42)`` at D = 128; ``--pna`` times PNA's forward
(full config, ogbn-products' size) with each kernel in turns, and the
kernel's share of it under ``torch.profiler``.  ``--phases`` adds, for
this tree's kernel, a diagnosis build (``SEG_PHASE_CLOCKS``) whose blocks
split their cycles between waiting for a chunk, summing it and releasing
it (thread 0's clock, mean a block).

Prints one JSON line per shape, then the card's name and power limit.
Needs an NVIDIA card with ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.segment_sum import ops
from repro_torch.kernels.segment_sum.kernel import (
    SegmentSumKernel,
    segment_levels,
    segment_sum_sorted,
)
from repro_torch.kernels.segment_sum.ref import reference_segment_sum

HBM_BYTES_PER_S = 3.35e12
OGBN_N, OGBN_E = 2_449_029, 61_859_140
#: (name, E, N, D, vals dtype, ids skew): ogbn-products at D = 128, PNA's
#: degrees and [E, 75] message, a MeshGraphNet minibatch_lg batch, MACE's
#: molecule batch (chip_smoke.py's SEG_GNN_SHAPES)
SHAPES = (
    ("ogbn_d128_uniform", OGBN_E, OGBN_N, 128, torch.float32, "uniform"),
    ("ogbn_d128_powerlaw", OGBN_E, OGBN_N, 128, torch.float32, "powerlaw"),
    ("pna_message_d75", OGBN_E, OGBN_N, 75, torch.float32, "uniform"),
    ("pna_message_d75_bf16", OGBN_E, OGBN_N, 75, torch.bfloat16, "uniform"),
    ("pna_degrees_d1", OGBN_E, OGBN_N, 1, torch.float32, "uniform"),
    ("meshgraphnet_d128", 168_960, 169_984, 128, torch.float32, "uniform"),
    ("mace_d1152", 8192, 3840, 1152, torch.float32, "uniform"),
)


def load_other(root: Path):
    """The other tree's launch wrapper instance, built from its own source."""
    path = root / "src" / "repro_torch" / "kernels" / "segment_sum" / "kernel.py"
    spec = importlib.util.spec_from_file_location(f"segment_sum_kernel_{root.name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kern = mod.SegmentSumKernel()
    kern.load()
    return kern


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def bound_ms(e: int, n: int, d: int, val_bytes: int, id_bytes: int) -> float:
    return (val_bytes * e * d + id_bytes * e + 4 * n * d) / HBM_BYTES_PER_S * 1e3


def held(out, ids, vals, n) -> float:
    """The largest |out - plain| as a share of the segment's sum of |vals|;
    raises past 1e-5."""
    ref = reference_segment_sum(ids, vals, n)
    mag = reference_segment_sum(ids, vals.float().abs(), n)
    err = (out - ref).abs()
    share = float((err / mag.clamp_min(1e-30)).max()) if err.numel() else 0.0
    if not bool((err <= 1e-5 * mag).all()):
        raise RuntimeError(f"kernel off the plain version by {share} of a segment's sum")
    return share


def _turns(others: dict) -> list[str]:
    """The others, this twice, the others in reverse."""
    return [*others, "this", "this", *reversed(list(others))]


def compare_shape(name, ids, vals, n, others: dict, reps: int, phases=None) -> dict:
    e, d = vals.shape
    kernels = {**others, "this": segment_sum_sorted}
    row = {"case": name, "E": e, "N": n, "D": d, "vals": str(vals.dtype)[6:],
           "levels": segment_levels(e, d),
           "bound_ms": bound_ms(e, n, d, vals.element_size(), ids.element_size())}
    for who, kern in kernels.items():
        before = kern.launches
        row[f"{who}_err_share"] = held(kern(ids, vals, n), ids, vals, n)
        row[f"{who}_launches"] = kern.launches - before
    for who, kern in kernels.items():  # the host's time to enqueue one call
        host = []
        for _ in range(20):
            t0 = time.perf_counter()
            kern(ids, vals, n)
            host.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
        row[f"{who}_host_us"] = float(np.median(host))
    turns = {who: [] for who in kernels}
    for who in _turns(others):
        kern = kernels[who]
        turns[who].append(median_ms(lambda: kern(ids, vals, n), reps))
    for who, t in turns.items():
        row[f"{who}_ms_turns"] = t
        row[f"{who}_ms"] = float(np.mean(t))
        row[f"{who}_over_bound"] = row[f"{who}_ms"] / row["bound_ms"]
    if phases is not None:
        fn = phases.load().segment_sum_phase_clocks
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        phases(ids, vals, n)  # warm-up
        torch.cuda.synchronize()
        fn((ctypes.c_uint64 * 4)())  # zero the sums
        phases(ids, vals, n)
        torch.cuda.synchronize()
        got = (ctypes.c_uint64 * 4)()
        fn(got)
        blocks = max(1, got[3])
        row["phase_cycles_per_block"] = {
            "wait": got[0] / blocks, "sum": got[1] / blocks, "release": got[2] / blocks,
            "blocks": got[3]}
    row["plain_ms"] = median_ms(lambda: reference_segment_sum(ids, vals, n), 3)
    ids_long = ids.long()
    lib_out = torch.zeros((n, d), dtype=vals.dtype, device=vals.device)
    row["library_ms"] = median_ms(lambda: lib_out.index_add_(0, ids_long, vals), 3)
    return row


def _ids(rng, e: int, n: int, skew: str, device) -> torch.Tensor:
    raw = rng.zipf(1.5, e) % n if skew == "powerlaw" else rng.integers(0, n, e)
    return torch.as_tensor(raw.astype(np.int32), device=device).sort().values


def pna_rows(others: dict, device, seed: int) -> dict:
    """PNA's full config at ogbn-products' size (as chip_smoke.py's gnn
    phase builds it), its forward timed with each kernel swapped into the
    entry point in turns, and one profiled forward each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import GRAPH_SHAPES
    from repro_torch.models.gnn import PNA, sort_edges

    shape = GRAPH_SHAPES["ogb_products"]
    gen = torch.Generator(device=device).manual_seed(seed + 10)
    src = torch.randint(0, OGBN_N, (OGBN_E,), generator=gen, device=device, dtype=torch.int32)
    dst = torch.randint(0, OGBN_N, (OGBN_E,), generator=gen, device=device, dtype=torch.int32)
    x = torch.randn((OGBN_N, shape.d_feat), generator=gen, device=device)
    model = PNA(ARCHS["pna"].config, shape.d_feat, 64, generator=torch.Generator().manual_seed(seed),
                device=device)
    edges = sort_edges(src, dst, OGBN_N)
    del src, dst
    kernels = {**others, "this": segment_sum_sorted}
    res = {"forward_ms_turns": {who: [] for who in kernels}, "launches": {}, "profile": {}}
    with torch.inference_mode():
        for who in _turns(others):
            ops.segment_sum_sorted = kernels[who]
            res["forward_ms_turns"][who].append(median_ms(lambda: model(x, edges), 3))
        for who, kern in kernels.items():
            ops.segment_sum_sorted = kern
            before = kern.launches
            model(x, edges)
            torch.cuda.synchronize()
            res["launches"][who] = kern.launches - before
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model(x, edges)
                torch.cuda.synchronize()
            # device activity only: a CPU op's row also carries its kernels' time
            rows = [(ev.name, ev.time_range.elapsed_us() / 1e3) for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA]
            res["profile"][who] = {
                "device_busy_ms": sum(ms for _, ms in rows),
                "segment_sum_kernel_ms": sum(ms for k, ms in rows if "segment_sum_level_kernel" in k),
            }
    ops.segment_sum_sorted = segment_sum_sorted
    res["forward_ms"] = {w: float(np.mean(t)) for w, t in res["forward_ms_turns"].items()}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, action="append",
                    help="root of another checkout (repeatable)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pna", action="store_true", help="also time PNA's forward")
    ap.add_argument("--livj", action="store_true", help="also sum LIVJ's destinations")
    ap.add_argument("--phases", action="store_true", help="also split a block's cycles")
    ap.add_argument("--only", action="append", default=None,
                    help="time only the SHAPES of this name (repeatable)")
    ap.add_argument("--out", default=None, help="also write every line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: needs an NVIDIA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    others = {Path(root).name: load_other(Path(root)) for root in args.other}
    segment_sum_sorted.load()
    phases = SegmentSumKernel(defines=("SEG_PHASE_CLOCKS",)) if args.phases else None
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    lines = []

    def emit(row):
        lines.append(row)
        print(json.dumps(row), flush=True)

    for name, e, n, d, vdt, skew in SHAPES:
        if args.only and name not in args.only:
            continue
        ids = _ids(rng, e, n, skew, device)
        vals = torch.randn((e, d), generator=gen, device=device).to(vdt)
        emit(compare_shape(name, ids, vals, n, others, args.reps, phases))
        del ids, vals
        torch.cuda.empty_cache()
    if args.livj:
        from repro_torch.graph.generators import rmat_graph

        g = rmat_graph(22, 8, seed=42)
        ids = torch.as_tensor(g.dst.astype(np.int32), device=device).sort().values
        vals = torch.randn((g.n_edges, 128), generator=gen, device=device)
        emit(compare_shape("livj_dst_d128", ids, vals, g.n_vertices, others, args.reps))
        del ids, vals, g
        torch.cuda.empty_cache()
    if args.pna:
        emit({"case": "pna_forward", **pna_rows(others, device, args.seed)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"nvidia_smi": smi, "rows": lines}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
