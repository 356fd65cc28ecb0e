"""Quickstart: the paper in one minute.

Builds a synthetic road graph, partitions it, runs the subgraph-centric BFS
to get the time function A, plans every placement strategy, and prints the
makespan/cost table (the paper's Fig. 3 in miniature).

  PYTHONPATH=src python -m repro_torch.examples.quickstart            # on the card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

import argparse

from repro_torch.core import (
    STRATEGIES,
    BillingModel,
    TimeFunction,
    build_metagraph,
    evaluate,
    opt_placement,
)
from repro_torch.core.metagraph import predict_time_function
from repro_torch.graph import bfs_grow_partition, road_grid_graph
from repro_torch.graph.bsp import run_sssp
from repro_torch.graph.config import EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    config = EngineConfig(device=args.device)

    print("== build + partition graph " + "=" * 40)
    g = road_grid_graph(80, 80, seed=1)
    pg = bfs_grow_partition(g, 8, seed=2)
    print(
        f"graph: {g.n_vertices} vertices, {g.n_edges} edges; "
        f"8 partitions, {pg.n_subgraphs} subgraphs, "
        f"edge cut {pg.edge_cut_fraction:.1%}, balance {pg.balance_factor():.3f}"
    )

    print("\n== run subgraph-centric BFS (collect time function A) " + "=" * 12)
    dist, trace = run_sssp(pg, source=0, config=config)
    print(
        f"BFS converged in {trace.n_supersteps} supersteps; "
        f"mean active partition fraction {trace.mean_active_fraction():.0%} "
        f"(the paper's Fig-2 under-utilization)"
    )
    tf = TimeFunction.from_trace(trace).scaled_to_tmin(90.0)

    print("\n== metagraph a-priori prediction " + "=" * 34)
    mg = build_metagraph(pg)
    pred_tf, sched = predict_time_function(pg, 0, mg=mg)
    print(
        f"metagraph: {mg.n_meta} meta-vertices / {mg.n_meta_edges} meta-edges; "
        f"predicts {sched.n_supersteps} supersteps (actual {trace.n_supersteps})"
    )

    print("\n== placement strategies (delta = 60s billing) " + "=" * 21)
    model = BillingModel(delta=60.0)
    print(f"{'strategy':10s} {'makespan':>9s} {'T/Tmin':>7s} {'cost':>5s} "
          f"{'core-secs':>10s} {'peak VMs':>9s}")
    for name, strat in STRATEGIES.items():
        r = evaluate(strat(tf), model)
        print(
            f"{name:10s} {r.makespan:8.1f}s {r.makespan_over_tmin:7.3f} "
            f"{r.cost_quanta:5d} {r.core_secs:10.1f} {r.peak_vms:9d}"
        )
    r_dm = evaluate(
        opt_placement(tf), model, data_movement=True,
        partition_bytes=pg.partition_bytes() * 2000.0,
    )
    print(
        f"{'opt-dm':10s} {r_dm.makespan:8.1f}s {r_dm.makespan_over_tmin:7.3f} "
        f"{r_dm.cost_quanta:5d} {r_dm.core_secs:10.1f} {r_dm.peak_vms:9d}"
        f"   (movement {r_dm.data_move_secs:.0f}s)"
    )
    print("\nelastic strategies cut cost vs the 8-VM default while OPT/FFD "
          "hold makespan at T_Min -- the paper's headline result.")


if __name__ == "__main__":
    main()
