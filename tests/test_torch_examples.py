"""Port parity, the example drivers: each ``repro_torch.examples`` driver
runs on the CPU at a small size, and prints the same numbers as the JAX
package's ``examples/`` script with the same arguments.

Each JAX example runs in its own process (``JAX_PLATFORMS=cpu``; the mesh
run forces its own host devices), all started together; the port's run
in-process through ``main(argv)``, its mesh run through gloo ranks.  Both
write their workload caches under a temporary directory.  Compared line by
line, exactly, after dropping the host wall time each executed-job line
reports and the mesh banner line (which names forced devices on one side
and ranks on the other).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CASES = {
    "quickstart": ("quickstart", []),
    "serving": ("elastic_serving", ["--queries", "48", "--rates", "5", "80"]),
    "bfs-usrn-bc": ("elastic_bfs", ["--workloads", "USRN/8P", "--bc", "4"]),
    "bfs-usrn-pagerank": (
        "elastic_bfs", ["--workloads", "USRN/8P", "--algorithm", "pagerank", "--window", "4"],
    ),
    "bfs-usrn-mesh-relayout": (
        "elastic_bfs",
        ["--workloads", "USRN/8P", "--mesh", "2", "--relayout", "--mirror-degree", "2",
         "--window", "2"],
    ),
}

_WALL = re.compile(r", wall [0-9.]+s on this host")


def _normalize(text: str) -> list[str]:
    return [_WALL.sub("", line) for line in text.splitlines() if not line.startswith("mesh:")]


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    """Start every JAX example at once; collect their stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    procs = {}
    for case, (script, args) in CASES.items():
        cwd = tmp_path_factory.mktemp(f"jax-{case}")
        procs[case] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{script}.py"), *args],
            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    out = {}
    for case, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, f"JAX {case} exited {p.returncode}:\n{stderr[-4000:]}"
        out[case] = stdout
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_example_prints_the_jax_examples_numbers(case, jax_outputs, tmp_path, monkeypatch, capsys):
    import importlib

    script, args = CASES[case]
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"repro_torch.examples.{script}")
    mod.main([*args, "--device", "cpu"])
    ours = capsys.readouterr().out
    assert _normalize(ours) == _normalize(jax_outputs[case])
    if "--mesh" in args:
        assert ours.splitlines()[0].startswith("mesh: 2 ranks over gloo on cpu")


def test_examples_refuse_a_cuda_run_without_cuda(tmp_path, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot show here")
    from repro_torch.examples import elastic_bfs, elastic_serving, quickstart

    monkeypatch.chdir(tmp_path)
    for main, argv in (
        (quickstart.main, []),
        (elastic_serving.main, ["--queries", "4"]),
        (elastic_bfs.main, ["--workloads", "USRN/8P"]),
        (elastic_bfs.main, ["--workloads", "USRN/8P", "--mesh", "2"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
