"""Nothing the harness or the reference loads is JAX or the JAX package.

The check compares each module's top-level name whole: ``repro_torch``
passes, ``repro`` fails.  A run is made in a fresh process (the test
process has the JAX package's tests beside it), and the harness's own files
are read for their imports; the reference and the comparison import
nothing of the program either.
"""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest

from bench_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH = ROOT / "bench"


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import json, sys\n"
        "sys.path.insert(0, 'bench/tests')\n"
        "import bench_tiny\n"
        "for w in ('livj-8p.sssp16', 'livj-8p.served'):\n"
        "    bench_tiny.run_tiny(w, trace=True)\n"
        "from bench import run\n"
        "print(json.dumps({'forbidden': run.forbidden_modules(),\n"
        "                  'top': sorted({m.split('.')[0] for m in sys.modules})}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["forbidden"] == []
    assert not FORBIDDEN & set(seen["top"])
    assert "repro_torch" in seen["top"]


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in BENCH.rglob("*.py")))
def test_no_file_of_the_benchmark_imports_jax(path):
    assert not FORBIDDEN & _imports(ROOT / path)


@pytest.mark.parametrize("name", ["reference.py", "check.py", "graphs.py", "traffic.py",
                                  "roofline.py", "trace.py"]
                         + sorted(p.relative_to(BENCH).as_posix()
                                  for p in (BENCH / "generators").glob("*.py")
                                  if p.name != "__init__.py"))
def test_yardstick_imports_nothing_of_the_program(name):
    assert not {"repro_torch", "repro"} & _imports(BENCH / name)


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files,
    a run ends in an error and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys\n"
        "sys.path.insert(0, '.')\n"
        "from bench import run\n"
        "run._setup_env(run.ROOT)\n"
        "print(run.run_cell(run.ROOT, 'livj-8p.sssp16', 1, 0.1, False, device='cpu',"
        " backend='torch'))\n"
    )
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


def test_without_a_card_the_command_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    out = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", "livj-8p.sssp16", "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA card" in out.stderr
