"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision below the configuration's
float32 (bfloat16), at the cell's own size.

    python -m bench.control --workload livj-8p.sssp16 --seeds 11 12 13

builds the configuration's graph as a run does and draws from each seed as
many sources as a run checks, then prints one JSON line a seed: the number the run compares
(``dist_rel_gap``) for the control, and for the reference in float32 beside
it.  A limit must pass sound runs of the program and fail the control;
``bench/tests/test_bench_control.py`` holds the same at a size the tests
can hold.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from bench.run import ROOT, _setup_env


def readings(cell, seed: int, device: str) -> dict:
    import torch

    from bench import spec
    from bench import traffic as traffic_gen

    prog = spec.program(cell.traffic["program"])
    g = spec.generator(cell.config["generator"]).generate(
        cell.config, int(cell.config["instance_seed"]), device
    )
    k = int(cell.traffic["check_sample"])
    sources = traffic_gen.rng(seed, traffic_gen.CHECK).integers(0, g.n, size=k).tolist()
    t = time.perf_counter()
    ref = prog.reference_rows(g, sources)
    ref_s = time.perf_counter() - t
    control = prog.reference_rows(g, sources, dtype=prog.CONTROL_DTYPE)
    f32 = prog.reference_rows(g, sources, dtype=torch.float32)
    return {
        "seed": seed,
        "control": {prog.NUMBER: prog.compare(control, ref), "dtype": str(prog.CONTROL_DTYPE)},
        "reference_float32": {prog.NUMBER: prog.compare(f32, ref)},
        "sources": len(sources),
        "reference_s": ref_s,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _setup_env(ROOT)
    from bench import spec

    cell = spec.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
