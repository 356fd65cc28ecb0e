"""End-to-end elastic graph processing driver (the paper's system, running).

For each paper workload: plan placement from the metagraph *prediction*
(launch-time planning, no profiling run), execute the chosen vertex program
under that plan on the elastic executor (partition state placed per
schedule, migration bytes billed), bill the actual execution, and compare
against the default placement and the trace-oracle plan.  Also demonstrates
dynamic re-planning (paper s7 future work) when the prediction diverges.

Knobs:
  --algorithm A  which ``graph.program`` VertexProgram to execute:
               ``bfs`` (default, hop counts), ``sssp`` (weighted edges),
               ``wcc`` (min label propagation), or ``pagerank`` (stationary,
               fixed budget).  The metagraph prediction is BFS-shaped, so
               non-BFS runs show the replanner correcting a genuinely wrong
               prior.
  --window K   supersteps per engine window (one O(K*P) counter pull per
               placement point -- ceil(S/K)+1 bulk pulls per run)
  --no-replan  disable online re-planning
  --mesh N     run the mesh engine on N ranks (``repro_torch.dist.run_ranks``:
               one process per rank; NCCL when N cards are visible, else gloo,
               on one shared card or on the CPU): the partition axis sharded
               over the ranks, a real all-to-all exchange, and per-window
               *physical* shard moves.  Prints per-rank shard residency at
               every window.
  --relayout   (with --mesh) dynamic re-layout: the compute layout follows
               the planner at every window boundary; ``--relayout auto`` is
               the cost-aware policy that vetoes swaps whose move bytes are
               not paid back by the remaining horizon.
  --mirror-degree T
               (with --mesh) mirror hub vertices with cross-partition
               in-degree >= T (one value per (rank, hub) per superstep).
  --backend B  ``cuda`` (the hand-written relax kernel; the default on a
               card) or ``torch`` (its plain version; the CPU's only one).
  --device D   ``cuda`` (default) or ``cpu``.

  PYTHONPATH=src python -m repro_torch.examples.elastic_bfs [--workloads LIVJ/8P ...]
  PYTHONPATH=src python -m repro_torch.examples.elastic_bfs --mesh 2 --relayout --device cpu
"""

import argparse

from repro_torch.core import (
    BillingModel,
    default_placement,
    evaluate,
    ffd_placement,
    lap_placement,
)
from repro_torch.core.elastic import ElasticBSPExecutor
from repro_torch.core.metagraph import predict_time_function
from repro_torch.core.timing import TimeFunction
from repro_torch.data import paper_workloads
from repro_torch.graph.config import EngineConfig
from repro_torch.graph.program import BUILTIN_PROGRAMS

STRATEGIES = {"ffd": ffd_placement, "lap": lap_placement}
#: with ``--mesh``, every rank is killed (and the driver fails) past this
MESH_TIMEOUT_S = 3600.0


def bc_demo(wl, n_sources: int, strat, model, config, emit):
    """Multi-wave BC on the batched engine: generate the whole wave trace in
    one traversal, then price the elasticity between waves (the paper's s7
    'sinusoidal' activation)."""
    from repro_torch.graph.bsp import run_bc_forward

    sources = [(i * 997) % wl.pg.graph.n_vertices for i in range(n_sources)]
    trace = run_bc_forward(wl.pg, sources, config=config)
    tf = TimeFunction.from_trace(trace).scaled_to_tmin(wl.tf.t_min() * n_sources)
    r = evaluate(strat(tf), model)
    r_def = evaluate(default_placement(tf), model)
    emit(
        f"BC {n_sources} waves ({trace.n_supersteps} supersteps, one batched "
        f"traversal): elastic {r.cost_quanta} vs default {r_def.cost_quanta} "
        f"core-min ({1 - r.cost_quanta / r_def.cost_quanta:.0%} saved)"
    )


def _print_residency(rep, n_devices: int, emit):
    """Per-window partition -> rank residency (the real migration)."""
    res = rep.residency
    if res is None or not len(res):
        return
    for w, row in enumerate(res):
        cells = " ".join(
            f"P{i}@d{int(d)}" if d >= 0 else f"P{i}@--"
            for i, d in enumerate(row)
        )
        moved = ""
        if w > 0:
            prev = res[w - 1]
            n_moved = int(((row != prev) & (prev >= 0) & (row >= 0)).sum())
            if n_moved:
                moved = f"   <- {n_moved} shard(s) moved devices"
        emit(f"  window {w:2d}: {cells}{moved}")
    emit(
        f"  physical: {rep.device_moves} device-to-device moves, "
        f"{rep.device_move_bytes} B crossed the {n_devices}-device mesh "
        f"(billed cloud moves: {rep.n_migrations} / {rep.migration_bytes} B)"
    )


def run(args, mesh=None, emit=print) -> None:
    """The driver's body: every workload planned, executed and billed (on
    ``mesh`` when given; every rank runs it)."""
    strat = STRATEGIES[args.strategy]
    model = BillingModel(delta=60.0)
    program = BUILTIN_PROGRAMS[args.algorithm]()
    dense = EngineConfig(device=args.device, backend=args.backend)
    for wl in paper_workloads(tuple(args.workloads), config=dense):
        emit(f"\n=== {wl.name} [{args.algorithm}] " + "=" * 40)
        # 1. a-priori plan from the metagraph (scaled to the same calibration)
        pred_tf, sched = predict_time_function(wl.pg, wl.source)
        pred_tf = pred_tf.scaled_to_tmin(wl.tf.t_min())
        plan = strat(pred_tf)
        emit(
            f"planned {plan.n_vms} VMs over {pred_tf.n_supersteps} predicted "
            f"supersteps from {wl.pg.n_subgraphs} metagraph vertices"
        )
        # 2. execute under the plan with dynamic re-planning enabled; the
        # metagraph prediction doubles as the replanner's sketch prior
        tau_scale = wl.tf.t_min() / max(1e-12, TimeFunction.from_trace(wl.trace).t_min())
        cfg = dense.replace(
            mesh=mesh, mirror_degree=args.mirror_degree, window=args.window,
            relayout=args.relayout,
        )
        ex = ElasticBSPExecutor(
            wl.pg, program=program, tau_scale=tau_scale, billing=model, config=cfg,
        )
        rep = ex.run(
            wl.source, plan, strategy_fn=strat, replan=not args.no_replan,
            sketch=None if args.no_replan else pred_tf,
        )
        emit(
            f"executed {rep.n_supersteps} supersteps in windows of "
            f"{rep.window} ({rep.host_syncs} host syncs, {rep.replans} "
            f"replans, {rep.n_migrations} migrations moving "
            f"{rep.migration_bytes} B, {rep.relayouts} compute re-layouts"
            + (
                f" ({rep.relayouts_skipped} vetoed by the payback policy)"
                if rep.relayouts_skipped else ""
            )
            + f", wall {rep.wall_seconds:.1f}s on this host)"
        )
        if mesh is not None:
            _print_residency(rep, mesh.world_size, emit)
        emit(
            f"actual billing: {rep.cost.cost_quanta} core-min, makespan "
            f"{rep.cost.makespan:.1f}s = {rep.cost.makespan_over_tmin:.2f}x "
            f"T_Min (migration {rep.migration_secs:.2f}s billed in)"
        )
        # 3. compare against default and the trace-oracle plan.  The
        # workload's recorded trace is a run of the default program (weighted
        # SSSP), so it is a fair oracle only when the executed algorithm is
        # that same program; otherwise judge against the executed tau.
        trace_matches = args.algorithm == "sssp" or (
            args.algorithm == "bfs" and wl.pg.graph.weights is None
        )
        oracle_tf = wl.tf if trace_matches else rep.actual_tau
        r_def = evaluate(default_placement(oracle_tf), model)
        r_oracle = evaluate(strat(oracle_tf), model)
        save = 1 - rep.cost.cost_quanta / r_def.cost_quanta
        emit(
            f"default: {r_def.cost_quanta} core-min | trace-oracle "
            f"{args.strategy}: {r_oracle.cost_quanta} core-min | "
            f"metagraph-planned: {rep.cost.cost_quanta} core-min "
            f"({save:.0%} saved vs default)"
        )
        if args.bc:
            bc_demo(wl, args.bc, strat, model, dense, emit)


def _rank_main(args_dict: dict) -> list[str]:
    """One mesh rank's run of the driver; returns the lines it printed."""
    from repro_torch.dist import partition_mesh

    lines: list[str] = []
    run(argparse.Namespace(**args_dict), mesh=partition_mesh(), emit=lines.append)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workloads", nargs="*", default=["LIVJ/8P", "USRN/8P"])
    ap.add_argument("--strategy", default="lap", choices=sorted(STRATEGIES))
    ap.add_argument(
        "--algorithm", default="bfs", choices=sorted(BUILTIN_PROGRAMS),
        help="VertexProgram to execute (see module docstring)",
    )
    ap.add_argument("--window", type=int, default=8, metavar="K",
                    help="supersteps per engine window")
    ap.add_argument("--no-replan", action="store_true",
                    help="disable online re-planning on prediction divergence")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the mesh engine on N ranks, with physical shard moves")
    ap.add_argument("--relayout", nargs="?", const=True, default=False,
                    choices=[True, "auto"], metavar="auto",
                    help="(with --mesh) the compute layout follows the planner; "
                    "'auto' for the cost-aware policy")
    ap.add_argument("--mirror-degree", type=int, default=None, metavar="T",
                    help="(with --mesh) mirror hub vertices with cross-partition "
                    "in-degree >= T")
    ap.add_argument("--backend", default=None, choices=["cuda", "torch"],
                    help="relax reduction: the CUDA kernel or its plain version "
                    "(default: the device's own)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--bc", type=int, default=0, metavar="N",
                    help="also run an N-source BC wave demo on the batched engine")
    args = ap.parse_args(argv)

    if args.mesh > 1:
        from repro_torch.dist import plan_ranks, run_ranks

        # build (and cache) the workloads once, before the ranks load them
        paper_workloads(tuple(args.workloads), config=EngineConfig(device=args.device))
        backend, devices = plan_ranks(args.mesh, args.device)
        print(
            f"mesh: {args.mesh} ranks over {backend} on {', '.join(sorted(set(devices)))}, "
            "partition axis sharded"
        )
        for line in run_ranks(_rank_main, args.mesh, device=args.device,
                              timeout=MESH_TIMEOUT_S, args=(vars(args),))[0]:
            print(line)
        return
    run(args)


if __name__ == "__main__":
    main()
