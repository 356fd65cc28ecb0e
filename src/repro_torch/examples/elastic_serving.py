"""Elastic traversal serving: the ``repro_torch.serve`` subsystem end to end.

Generates a seeded open-loop Poisson arrival trace over an R-MAT graph and
serves it twice with ``TraversalService`` -- once with elastic per-window VM
capacity (activity forecast + Ghaderi queue-drift rule) and once statically
provisioned at ``max_vms`` -- then prints the throughput / sojourn / cost
comparison at several arrival rates.  Every number comes off the simulated
clock, so reruns are bit-for-bit identical, on the card or the CPU.

  PYTHONPATH=src python -m repro_torch.examples.elastic_serving
  PYTHONPATH=src python -m repro_torch.examples.elastic_serving --rates 2 8 32 --queries 200
  PYTHONPATH=src python -m repro_torch.examples.elastic_serving --device cpu
"""

import argparse
import dataclasses

from repro_torch.graph.config import EngineConfig
from repro_torch.graph.generators import rmat_graph
from repro_torch.graph.partition import hash_partition
from repro_torch.serve import ServiceConfig, TraversalService, poisson_trace


def serve_at_rate(pg, rate, n_queries, cfg, seed, engine_config):
    trace = poisson_trace(n_queries, rate, pg.graph.n_vertices, seed=seed)
    elastic = TraversalService(pg, config=cfg, engine_config=engine_config).run(trace)
    static = TraversalService(
        pg, config=dataclasses.replace(cfg, static_vms=cfg.max_vms),
        engine_config=engine_config,
    ).run(trace)
    return elastic, static


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=9, help="R-MAT log2 vertices")
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--queries", type=int, default=120)
    ap.add_argument(
        "--rates", type=float, nargs="+", default=[5.0, 20.0, 80.0],
        help="arrival rates, queries/sec of simulated time",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    engine_config = EngineConfig(device=args.device)

    g = rmat_graph(args.scale, args.degree, seed=args.seed)
    pg = hash_partition(g, args.parts, seed=args.seed)
    # tau_scale lifts the microsecond-scale modeled supersteps into a regime
    # where the demo rates are meaningful while a whole run's busy span still
    # fits inside one billing quantum (delta=60s) -- otherwise every elastic
    # session spans >delta and bills the same as static regardless of capacity
    cfg = ServiceConfig(s_batch=8, window=8, tau_scale=1e3)
    print(
        f"serving R-MAT 2^{args.scale} (deg {args.degree}, {args.parts} "
        f"parts): {args.queries} queries per rate, elastic "
        f"[{cfg.min_vms}..{cfg.max_vms}] VMs vs static {cfg.max_vms}"
    )
    hdr = (
        f"{'rate':>6s} {'mode':>8s} {'done':>5s} {'qps':>7s} {'p50':>7s} "
        f"{'p99':>7s} {'occ':>5s} {'vms':>5s} {'quanta':>6s} {'cost/1k':>8s}"
    )
    print(hdr)
    for rate in args.rates:
        elastic, static = serve_at_rate(pg, rate, args.queries, cfg, args.seed, engine_config)
        for mode, r in (("elastic", elastic), ("static", static)):
            print(
                f"{rate:6.1f} {mode:>8s} {r.completed:5d} "
                f"{r.queries_per_sec:7.2f} {r.sojourn_p50:7.3f} "
                f"{r.sojourn_p99:7.3f} {r.occupancy:5.2f} "
                f"{r.capacity_mean:5.2f} {r.cost.cost_quanta:6d} "
                f"{r.cost_per_1k_queries:8.1f}"
            )
    print(
        "\nelastic capacity rides the arrival rate: near-static latency "
        "(within the scheduler's stretch bound) at a fraction of the billed "
        "quanta when the queue is short, ramping to full capacity under "
        "backlog."
    )


if __name__ == "__main__":
    main()
