"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, every module imports in a
process where both are blocked, and the chip smoke refuses to report a
result on a machine without a card.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
PORT_FILES = sorted(PKG.rglob("*.py")) + [SMOKE]


def _module_name(path: Path) -> str:
    parts = path.relative_to(PKG.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_port_file_imports_neither_jax_nor_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_every_module_imports_with_jax_and_repro_blocked():
    modules = sorted(
        _module_name(p) for p in PKG.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        "for blocked in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[blocked] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= len(modules)


def _run_smoke(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=300, cwd=str(cwd), env=env,
    )


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot show here")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "CUDA" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_entry_points_refuse_a_cuda_config_without_cuda(tmp_path):
    """No quiet CPU run: the executor, the session, the service, the
    one-superstep oracle and the workloads raise on the default (CUDA)
    config where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot show here")
    from repro_torch.core.elastic import ElasticBSPExecutor
    from repro_torch.data import paper_workloads
    from repro_torch.graph import bfs_grow_partition, open_session, rmat_graph
    from repro_torch.graph.traversal import make_superstep_fn
    from repro_torch.serve import TraversalService

    pg = bfs_grow_partition(rmat_graph(6, 4, seed=0), 2, seed=0)
    entries = {
        "executor": lambda: ElasticBSPExecutor(pg),
        "session": lambda: open_session(pg),
        "service": lambda: TraversalService(pg),
        "superstep": lambda: make_superstep_fn(pg),
        "workloads": lambda: paper_workloads(("LIVJ/8P",), cache_dir=str(tmp_path)),
    }
    for name, entry in entries.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
        assert not list(tmp_path.iterdir()), f"{name} wrote before refusing"
