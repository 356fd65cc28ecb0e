"""Tiny cells for the CPU tests: each workload of BENCHMARK.json with its
configuration cut to a size a test run holds, run through the harness on
the CPU with the program's plain ``torch`` backend.  The keys that cut a
configuration come from its generator module (``TINY``), so a new kind of
graph brings its own test size.

``OPEN_LOOP`` is one more: the open loop of served queries
(``bench.loops.open_loop``), which no cell of BENCHMARK.json drives yet.
It runs on the LIVJ configuration with a mix defined here, so that the
served cell of PERF.md's Open questions needs only its own files.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: a closed loop's pool cut to one batch, so that a window of any length
#: keeps 12 of a batch's 16 rows and a fault in half of them always shows
TINY_POOL = {"pool_batches": 1}
SECONDS = 0.6
OPEN_LOOP = "livj-8p.served"
#: the open loop's mix in the tests: Poisson queries at a test's rate
OPEN_MIX = {"loop": "open", "program": "sssp", "rate_qps": 30.0, "arrivals": "poisson",
            "sources": "uniform", "check_sample": 8, "service": {}}
OPEN_END_TO_END = {"name": "query_p95_s", "unit": "s", "better": "lower", "bound": 0.2,
                   "source": "host_clock"}

WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiny_keys(generator: str) -> dict:
    """The keys that shrink a configuration of ``generator`` to a test's
    size: its module's ``TINY``."""
    from bench import spec

    module = spec.generator(generator)
    try:
        return dict(module.TINY)
    except AttributeError:
        raise AttributeError(
            f"{module.__name__} has no TINY: a generator gives the configuration keys "
            "that shrink it to a test's size"
        ) from None


def tiny_cell(workload: str):
    from bench import spec

    if workload == OPEN_LOOP:
        cell = spec.load_cell(ROOT, "livj-8p.sssp16")
        cell.workload, cell.traffic = workload, dict(OPEN_MIX)
        cell.end_to_end = [OPEN_END_TO_END] + [m for m in cell.end_to_end if m["name"] == "setup_s"]
        cell.per_layer = [m for m in cell.per_layer if m["moves"] == "setup_s"]
    else:
        cell = spec.load_cell(ROOT, workload)
    cell.config.update(tiny_keys(cell.config["generator"]))
    if cell.traffic["loop"] == "closed":
        cell.traffic.update(TINY_POOL)
    return cell


def run_tiny(workload: str, seed: int = 2**31 + 11, trace: bool = False):
    from bench import run

    return run.run_cell(ROOT, workload, seed, SECONDS, trace, device="cpu", backend="torch",
                        cell=tiny_cell(workload))
