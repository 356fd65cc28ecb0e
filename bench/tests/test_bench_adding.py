"""A new kind of graph enters the benchmark as files alone.

Every generator module gives ``TINY``, the configuration keys that shrink
it to a test's size, and one without it is named in the error.  In a copy
of ``BENCHMARK.json`` and ``bench/``, a cell on the road generator is added
with a configuration file, a limits file, an entry in ``configs`` and one
in ``workloads`` on the existing mix, and its name in the metrics'
``workloads`` lists; no other file of the copy changes, and the spec checks
and the tiny run on the CPU pass against it.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from bench_tiny import ROOT, tiny_keys

BENCH = ROOT / "bench"
GENERATORS = sorted(p.stem for p in (BENCH / "generators").glob("*.py") if p.name != "__init__.py")

CELL = "road-test.sssp16"
CONFIG = {
    "name": "road-test",
    "about": "a small road lattice with closures, for the test that a cell is added as files alone",
    "generator": "road",
    "instance_seed": 31,
    "width": 48,
    "height": 40,
    "keep": 0.69,
    "weight_low": 0.0,
    "weight_high": 1.0,
    "parts": 8,
    "partitioner": "bfs_grow_partition",
    "precision": "float32",
}
CONFIG_ENTRY = {
    "name": "road-test",
    "source": "http://www.diag.uniroma1.it/challenge9/download.shtml",
    "file": "bench/configs/road-test.json",
    "reduced": ["width", "height"],
    "why": "a road lattice with closures at a test's size",
}
WORKLOAD_ENTRY = {
    "name": CELL,
    "config": "road-test",
    "traffic": "sssp16",
    "chips": 1,
    "why": "closed loop of 16-source SSSP batches on a road lattice: many closure iterations",
}


@pytest.mark.parametrize("name", GENERATORS)
def test_every_generator_brings_its_test_size(name):
    keys = tiny_keys(name)
    assert keys and all(isinstance(k, str) for k in keys)
    for path in sorted((BENCH / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        if cfg["generator"] == name:  # it cuts keys the configuration has
            assert set(keys) <= set(cfg), path.name


def test_a_generator_without_a_test_size_is_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "bench.generators.bare", types.ModuleType("bench.generators.bare"))
    with pytest.raises(AttributeError, match=r"bench\.generators\.bare has no TINY"):
        tiny_keys("bare")


def _digests(root) -> dict:
    return {
        p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in root.rglob("*")
        if p.is_file() and "__pycache__" not in p.parts
    }


def _add_cell(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    spec["configs"].append(CONFIG_ENTRY)
    spec["workloads"].append(WORKLOAD_ENTRY)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    return spec


def test_a_road_cell_is_added_as_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    (tmp_path / CONFIG_ENTRY["file"]).write_text(json.dumps(CONFIG, indent=2))
    (tmp_path / "bench" / "limits" / f"{CELL}.json").write_text(
        json.dumps({"limits": {"failed": 0, "dist_rel_gap": 3e-4}})
    )
    original = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(_add_cell(original), indent=1))

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "HOME": str(tmp_path)}
    checks = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", "bench/tests/test_bench_spec.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env,
    )
    assert checks.returncode == 0, checks.stdout[-3000:] + checks.stderr[-3000:]
    assert f"test_each_piece_is_found_by_name[{CELL}] PASSED" in checks.stdout

    code = (
        "import json, sys\n"
        "sys.path.insert(0, 'bench/tests')\n"
        "import bench_tiny\n"
        f"out = [bench_tiny.run_tiny({CELL!r}, trace=t)[0] for t in (False, True)]\n"
        "print(json.dumps(out))\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    plain, traced = json.loads(run.stdout.strip().splitlines()[-1])
    for result in (plain, traced):
        assert result["correct"] is True, result["checks"]
        assert result["failed"] == 0 and result["attempted"] > 0
    assert plain["metrics"]["gteps"]["value"] > 0 and plain["metrics"]["setup_s"]["value"] > 0
    assert {"partition_s", "layout_s", "host_syncs_per_batch.batch"} <= set(traced["metrics"])

    # two new files and BENCHMARK.json's additions; every other file as it was
    after = _digests(tmp_path)
    assert set(after) - set(before) == {CONFIG_ENTRY["file"], f"bench/limits/{CELL}.json"}
    assert {k for k in before if after[k] != before[k]} == {"BENCHMARK.json"}
