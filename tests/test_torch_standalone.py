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


def test_mesh_and_example_packages_are_held_standalone():
    """The multi-GPU slice's packages are among the files and modules the
    checks above cover."""
    names = {_module_name(p) for p in PORT_FILES if p != SMOKE}
    for mod in (
        "repro_torch.dist", "repro_torch.dist.sharding", "repro_torch.dist.launch",
        "repro_torch.dist._rank", "repro_torch.graph.mesh_exchange",
        "repro_torch.examples", "repro_torch.examples.quickstart",
        "repro_torch.examples.elastic_bfs", "repro_torch.examples.elastic_serving",
    ):
        assert mod in names, mod


def _rank_foreign_modules() -> list:
    """What a mesh rank process has imported of JAX or the JAX package,
    after running the mesh engine and an example driver's rank body."""
    from repro_torch.dist import partition_mesh
    from repro_torch.examples import elastic_bfs  # noqa: F401
    from repro_torch.graph import bfs_grow_partition, rmat_graph
    from repro_torch.graph.config import EngineConfig
    from repro_torch.graph.traversal import get_engine

    pg = bfs_grow_partition(rmat_graph(6, 4, seed=0), 4, seed=0)
    get_engine(pg, config=EngineConfig(device="cpu", mesh=partition_mesh())).run([0])
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def test_mesh_ranks_import_neither_jax_nor_repro():
    from repro_torch.dist import run_ranks

    for foreign in run_ranks(_rank_foreign_modules, 2, device="cpu", timeout=300):
        assert foreign == []


def test_gnn_slice_modules_are_held_standalone():
    """The GNN slice's modules are among the files and modules the checks
    above cover, and its models refuse a CUDA build without a card."""
    names = {_module_name(p) for p in PORT_FILES if p != SMOKE}
    for mod in (
        "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.registry",
        "repro_torch.configs.pna", "repro_torch.configs.meshgraphnet",
        "repro_torch.configs.mace", "repro_torch.configs.dimenet",
        "repro_torch.configs.mixtral_8x22b", "repro_torch.configs.deepseek_v3_671b",
        "repro_torch.configs.granite_3_8b", "repro_torch.configs.mistral_nemo_12b",
        "repro_torch.configs.tinyllama_1_1b", "repro_torch.configs.deepfm",
        "repro_torch.models", "repro_torch.models.common", "repro_torch.models.gnn",
        "repro_torch.models.gnn.message_passing", "repro_torch.models.gnn.pna",
        "repro_torch.models.gnn.meshgraphnet", "repro_torch.models.gnn.e3",
        "repro_torch.models.gnn.mace", "repro_torch.models.gnn.dimenet",
        "repro_torch.models.gnn.halo_pna", "repro_torch.graph.sampler",
        "repro_torch.dist.halo",
    ):
        assert mod in names, mod
    if torch.cuda.is_available():
        return
    from repro_torch.configs import ARCHS
    from repro_torch.models.gnn import MACE, PNA, DimeNet, MeshGraphNet

    for build in (
        lambda: PNA(ARCHS["pna"].config, 4, 2),
        lambda: MeshGraphNet(ARCHS["meshgraphnet"].config, 4, 4, 2),
        lambda: MACE(ARCHS["mace"].config),
        lambda: DimeNet(ARCHS["dimenet"].config),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_lm_recsys_slice_modules_are_held_standalone():
    """The LM and recsys slice's modules are among the files and modules the
    checks above cover, and their entry points refuse CUDA without a card."""
    names = {_module_name(p) for p in PORT_FILES if p != SMOKE}
    for mod in (
        "repro_torch.models.attention", "repro_torch.models.moe",
        "repro_torch.models.transformer", "repro_torch.models.recsys",
        "repro_torch.models.recsys.embedding", "repro_torch.models.recsys.deepfm",
        "repro_torch.data.synthetic", "repro_torch.launch", "repro_torch.launch.steps",
        "repro_torch.launch.serve",
    ):
        assert mod in names, mod
    if torch.cuda.is_available():
        return
    from repro_torch.launch.steps import build_bundle
    from repro_torch.models.recsys import DeepFM
    from repro_torch.configs import ARCHS

    for build in (
        lambda: DeepFM(ARCHS["deepfm"].config),
        lambda: build_bundle("deepfm", "serve_p99", reduced=True),
        lambda: build_bundle("mixtral-8x22b", "decode_32k", reduced=True),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_analysis_slice_modules_are_held_standalone():
    """The analysis slice's modules are among the files and modules the
    checks above cover, and its CLI, which audits on the card by default,
    refuses to run without one rather than falling back to the CPU."""
    names = {_module_name(p) for p in PORT_FILES if p != SMOKE}
    for mod in (
        "repro_torch.analysis", "repro_torch.analysis.__main__",
        "repro_torch.analysis.findings", "repro_torch.analysis.registry",
        "repro_torch.analysis.lint", "repro_torch.analysis.trace_audit",
        "repro_torch.analysis.fixtures",
    ):
        assert mod in names, mod
    if torch.cuda.is_available():
        return
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis"], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT), env=env,
    )
    assert proc.returncode != 0 and "finding" not in proc.stdout
    assert "CUDA is not available" in proc.stderr
