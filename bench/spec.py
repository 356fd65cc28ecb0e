"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each workload's configuration and traffic mix;
each lives in a file of its own: ``bench/configs/<config>.json``,
``bench/traffic/<traffic>.json``, a generator module
``bench/generators/<generator>.py`` named by the configuration, a program
module ``bench/programs/<program>.py`` named by the mix, a limits file
``bench/limits/<workload>.json``, and one reader per per-layer metric,
``bench/metrics/<metric>.py``.  Adding a cell adds files; it edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path


@dataclasses.dataclass
class Cell:
    workload: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict  # bench/limits/<workload>.json: number compared -> limit


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str, end_to_end_names: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in end_to_end_names


def load_cell(root: Path, workload: str) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        names = ", ".join(w["name"] for w in bench["workloads"])
        raise SystemExit(f"unknown workload {workload!r} (BENCHMARK.json has {names})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _load_json(root / conf["file"])
    traffic = _load_json(root / "bench" / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    limits = {k: float(v) for k, v in
              _load_json(root / "bench" / "limits" / f"{workload}.json")["limits"].items()}
    return Cell(workload, int(entry["chips"]), config, traffic, e2e, per_layer, limits)


def generator(name: str):
    return importlib.import_module(f"bench.generators.{name}")


def program(name: str):
    return importlib.import_module(f"bench.programs.{name}")


def metric_reader(root: Path, name: str):
    """The ``read(record) -> float | None`` of ``bench/metrics/<name>.py``
    (loaded by path: metric names hold dots)."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
