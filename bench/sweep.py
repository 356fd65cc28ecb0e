"""Find a served cell's knee: the highest offered rate whose backlog does
not grow.

    python -m bench.sweep --workload <served cell> --seed 7 --seconds 40 --rates 1 2 3 4

builds the cell once (as a run does), then offers each rate for
``--seconds`` through the same open loop and prints one JSON line a rate:
queries offered and served, the median and 95th percentile latency, the
mean latency of the window's first and last thirds of queries (a backlog
that grows shows as a last third far slower than the first), and the calls
and engine windows.  The knee found is written into the mix's file by hand
as a fixed rate; runs of the benchmark never search.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from bench.run import ROOT, _setup_env, build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    _setup_env(ROOT)
    import torch

    from bench import loops, spec

    if not torch.cuda.is_available():
        print("bench.sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    t = time.perf_counter()
    ctx, _, spans = build(cell, args.seed, "cuda", "cuda")
    print(json.dumps({"setup_s": time.perf_counter() - t, "spans": spans}), flush=True)
    for rate in args.rates:
        traffic = dict(cell.traffic, rate_qps=rate)
        out = loops.open_loop(ctx, traffic, args.seconds, args.seed, loops.Tracer(False, "cuda"))
        lat = out["latency"]
        third = max(1, lat.shape[0] // 3)
        served = np.isfinite(lat)
        print(json.dumps({
            "rate_qps": rate, "offered": int(lat.shape[0]), "served": int(served.sum()),
            "window_s": out["window_s"],
            "p50_s": float(np.percentile(lat[served], 50)) if served.any() else None,
            "p95_s": float(np.percentile(lat, 95)),
            "first_third_mean_s": float(lat[:third].mean()),
            "last_third_mean_s": float(lat[-third:].mean()),
            "calls": out["calls"], "windows": out["windows"], "occupancy": out["occupancy"],
            "rejected": out["rejected"], "dropped": out["dropped"],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
