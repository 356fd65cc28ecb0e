"""Size a closed cell's pool: how many batches a window runs once.

    python -m bench.pool --workload <closed cell> --seed 7 --batches 12 --seconds 51

builds the cell once (as a run does), then runs each of the first
``--batches`` batches of the instance's pool once, in the pool's order, and
prints one JSON line a batch: the supersteps of its longest row, its
closure iterations (each superstep's iterations are its longest row's,
since the engine iterates while any row is active; summed over the
supersteps), the longest row's own sum, the host reads, and its seconds.
The last line gives, for a pool of each size ``k`` (the pool is drawn row
by row, so a pool of ``k`` batches is the first ``k`` of a larger one), the
``gteps`` a window of ``--seconds`` reads over ``ORDERS`` orders of the
pool, as shares of their median, and whether every order passes
``--seconds`` only in its last batch.  The size chosen is written into the
mix's file by hand; runs of the benchmark never search.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

from bench import loops
from bench import traffic as traffic_gen
from bench.run import ROOT, _nvidia_smi, _setup_env, build

#: orders of the pool drawn to read a window's spread
ORDERS = 2000


def window_rates(times: list[float], seconds: float, orders: int, seed: int) -> np.ndarray:
    """Batches a second of a closed loop over a pool of batches that take
    ``times`` seconds, in ``orders`` runs: each pass over the pool in a new
    order, the window ending at the first batch that ends past ``seconds``
    (as ``bench.loops.closed_loop`` does)."""
    draw = np.random.default_rng(seed)
    rates = np.empty(orders)
    for i in range(orders):
        elapsed, done = 0.0, 0
        while elapsed < seconds:
            for b in draw.permutation(len(times)):
                elapsed += times[b]
                done += 1
                if elapsed >= seconds:
                    break
        rates[i] = done / elapsed
    return rates


def pool_sizes(times: list[float], seconds: float, seed: int) -> list[dict]:
    """For each pool of the first ``k`` batches: its seconds, whether every
    order passes ``seconds`` only in its last batch, and the window's
    ``gteps`` over orders as shares of their median (least, quartiles,
    most) with the quartiles' spread."""
    out = []
    for k in range(1, len(times) + 1):
        head = times[:k]
        rates = window_rates(head, seconds, ORDERS, seed)
        mid = float(np.median(rates))
        q1, _, q3 = statistics.quantiles(rates.tolist(), n=4)
        out.append({
            "k": k,
            "pool_s": sum(head),
            "last_batch_only": sum(head) - min(head) < seconds <= sum(head),
            "least": float(rates.min()) / mid,
            "q1": q1 / mid,
            "q3": q3 / mid,
            "most": float(rates.max()) / mid,
            "spread": (q3 - q1) / mid,
        })
    return out


def first_batches(traffic: dict, n: int, instance: int, k: int) -> np.ndarray:
    """``[k, batch]``: the first ``k`` batches of the instance's pool, in the
    pool's order, drawn as ``bench.traffic.pool_batches`` draws them."""
    shape = (k, int(traffic["batch"]))
    return traffic_gen.rng(instance, traffic_gen.SOURCES).integers(0, n, size=shape, dtype=np.int64)


def batch_table(ctx, pool: np.ndarray):
    """One row a batch of ``pool``, each run once through the call the
    closed loop makes, timed between two synchronizations."""
    from repro_torch.graph.traversal import TraversalNotConverged

    device = ctx.session.config.device
    for b, sources in enumerate(pool):
        reads = loops.counters(ctx)["engine.host_syncs"]
        loops.sync(device)
        t = time.perf_counter()
        try:
            res, converged = ctx.session.run(ctx.program, sources), True
        except TraversalNotConverged as exc:
            res, converged = exc.result, False
        loops.sync(device)
        seconds = time.perf_counter() - t
        inner = np.asarray(res.inner_iters)
        yield {
            "batch": b,
            "converged": converged,
            "supersteps": int(np.asarray(res.n_supersteps).max()),
            "closure_iterations": int(inner.max(axis=0).sum()),
            "longest_row_iterations": int(inner.sum(axis=1).max()),
            "host_reads": loops.counters(ctx)["engine.host_syncs"] - reads,
            "seconds": seconds,
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bench.pool")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    _setup_env(ROOT)
    import torch

    from bench import spec

    if not torch.cuda.is_available():
        print("bench.pool: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    if cell.traffic["loop"] != "closed":
        print(f"bench.pool: {args.workload} is not a closed loop", file=sys.stderr)
        return 2
    t = time.perf_counter()
    ctx, g, spans = build(cell, args.seed, "cuda", "cuda")
    print(json.dumps({"card": _nvidia_smi(), "setup_s": time.perf_counter() - t, "spans": spans,
                      "graph": {"n": g.n, "undirected_edges": g.n_undirected,
                                "components_of_draw": g.n_components}}), flush=True)
    times = []
    for row in batch_table(ctx, first_batches(cell.traffic, ctx.n, ctx.instance, args.batches)):
        times.append(row["seconds"])
        print(json.dumps(row), flush=True)
    print(json.dumps({"seconds": args.seconds, "pools": pool_sizes(times, args.seconds, args.seed)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
