"""Start the ranks of a partition mesh on one host (the port's stand-in for
``repro.testing.forced_devices``: where the JAX package fakes devices in one
process, the port runs one process per mesh rank).

``run_ranks(target, n_ranks, device=..., timeout=...)`` starts ``n_ranks``
Python processes (``python -m repro_torch.dist._rank``), each of which
joins one process group through a ``file://`` store in a fresh temporary
directory -- no TCP port to pick, so concurrent launches (test workers)
never clash -- runs ``target(*args, **kwargs)`` and pickles its return
value back.  ``target`` is a module-level function; the rank imports its
module by name, or from its file when the module is ``__main__``.

  * **Backend.**  ``device="cuda"`` gives every rank its own card with NCCL
    when at least ``n_ranks`` cards are visible; otherwise every rank shares
    ``cuda:0`` over gloo (NCCL refuses two ranks on one card), which copies
    the CUDA payloads through host memory itself.  ``device="cpu"`` is gloo
    on the CPU.  ``plan_ranks`` names the choice before the launch and
    ``RankResults`` carries it after.
  * **Failure.**  A rank that exits non-zero, or a launch that passes
    ``timeout`` seconds, kills every rank and raises ``RankFailed`` with
    each rank's exit code and the tail of its output.  The process group
    itself gets the same timeout, so a rank stuck in a collective whose peer
    died fails instead of hanging.
  * Each rank runs ``torch.set_num_threads(1)``: D ranks share the host's
    cores.

``share_graph(pg, directory)`` writes a graph, its partition edge layout and
the layout's per-partition slices as ``.npy`` files; ``load_shared_graph``
maps them back read-only in a rank and seeds the graph's caches, so the
edge layout, which takes a quarter of a minute to build at LiveJournal's
size, is built once, in the parent, the ranks share its pages, and each
rank builds only its own block of the mesh layout on top of it
(``partition.mesh_rank_layout``).
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

_SRC = str(Path(__file__).resolve().parents[2])


class RankFailed(RuntimeError):
    """A rank exited non-zero or the launch passed its deadline."""


class RankResults(list):
    """Each rank's return value, in rank order, plus how they ran."""

    backend: str
    devices: list
    seconds: float


def plan_ranks(n_ranks: int, device: str = "cuda") -> tuple[str, list[str]]:
    """``(backend, per-rank device strings)`` for ``n_ranks`` on this host."""
    n_ranks = int(n_ranks)
    if n_ranks < 1:
        raise ValueError(f"need at least one rank, got {n_ranks}")
    kind = torch.device(device).type
    if kind == "cpu":
        return "gloo", ["cpu"] * n_ranks
    if kind != "cuda":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA ranks were requested but CUDA is not available; pass device='cpu'"
        )
    if torch.cuda.device_count() >= n_ranks:
        return "nccl", [f"cuda:{r}" for r in range(n_ranks)]
    return "gloo", ["cuda:0"] * n_ranks


def _target_spec(target) -> tuple[str, str, str | None]:
    mod = sys.modules.get(target.__module__)
    file = getattr(mod, "__file__", None)
    return target.__module__, target.__qualname__, file


def _tail(path: Path, n: int = 4000) -> str:
    try:
        text = path.read_text(errors="replace")
    except OSError:
        return ""
    return text[-n:]


def run_ranks(
    target,
    n_ranks: int,
    *,
    device: str = "cuda",
    timeout: float = 600.0,
    args: tuple = (),
    kwargs: dict | None = None,
) -> RankResults:
    """Run ``target(*args, **kwargs)`` on ``n_ranks`` mesh ranks (see the
    module docstring); returns each rank's result in rank order."""
    backend, devices = plan_ranks(n_ranks, device)
    work = Path(tempfile.mkdtemp(prefix="repro_torch_ranks_"))
    procs: list[subprocess.Popen] = []
    t0 = time.perf_counter()
    try:
        payload = {
            "target": _target_spec(target), "n_ranks": int(n_ranks),
            "backend": backend, "devices": devices, "timeout": float(timeout),
        }
        (work / "payload.json").write_text(json.dumps(payload))
        # the arguments are unpickled after the target's module is imported,
        # so they may hold that module's own types
        (work / "args.pkl").write_bytes(pickle.dumps((args, kwargs or {})))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_SRC, env.get("PYTHONPATH", "")) if p
        )
        for r in range(int(n_ranks)):
            out = open(work / f"rank{r}.log", "wb")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.dist._rank", str(work), str(r)],
                stdout=out, stderr=subprocess.STDOUT, env=env,
            ))
            out.close()
        deadline = time.monotonic() + float(timeout)
        while True:
            rcs = [p.poll() for p in procs]
            failed = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if failed or time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                why = (f"rank(s) {failed} exited non-zero" if failed
                       else f"the launch passed its {timeout:.0f} s deadline")
                logs = "\n".join(
                    f"--- rank {r} (exit {p.returncode}) ---\n{_tail(work / f'rank{r}.log')}"
                    for r, p in enumerate(procs)
                )
                raise RankFailed(f"{n_ranks}-rank {backend} launch failed: {why}\n{logs}")
            if all(rc == 0 for rc in rcs):
                break
            time.sleep(0.02)
        results = RankResults(
            pickle.loads((work / f"result{r}.pkl").read_bytes()) for r in range(int(n_ranks))
        )
        results.backend = backend
        results.devices = devices
        results.seconds = time.perf_counter() - t0
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


def _resolve_target(spec):
    """The target function: its module imported by name, or loaded from its
    file (a ``__main__`` script, or a test module not on the path)."""
    module, qualname, file = spec
    mod = None
    if module != "__main__":
        try:
            mod = importlib.import_module(module)
        except ImportError:
            if file is None:
                raise
    if mod is None:
        name = Path(file).stem
        loader_spec = importlib.util.spec_from_file_location(name, file)
        mod = importlib.util.module_from_spec(loader_spec)
        sys.modules[name] = mod
        loader_spec.loader.exec_module(mod)
    obj = mod
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _rank_main(work: str, rank: int) -> None:
    import torch.distributed as dist

    from repro_torch.dist import sharding

    work_dir = Path(work)
    payload = json.loads((work_dir / "payload.json").read_text())
    torch.set_num_threads(1)
    device = torch.device(payload["devices"][rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    sharding._RANK_DEVICE = device
    dist.init_process_group(
        payload["backend"], init_method=f"file://{work_dir / 'store'}",
        rank=rank, world_size=payload["n_ranks"],
        timeout=datetime.timedelta(seconds=payload["timeout"]),
    )
    try:
        sys.path.insert(0, os.getcwd())
        target = _resolve_target(payload["target"])
        args, kwargs = pickle.loads((work_dir / "args.pkl").read_bytes())
        result = target(*args, **kwargs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    tmp = work_dir / f"result{rank}.pkl.tmp"
    tmp.write_bytes(pickle.dumps(result))
    os.replace(tmp, work_dir / f"result{rank}.pkl")


# -- handing a large graph to the ranks ----------------------------------------


#: the per-partition index groups of ``partition._PartSlices``, written as
#: one concatenated array and its group sizes each
_SLICE_GROUPS = ("verts", "lsel", "rsel", "rin")
_SLICE_ARRAYS = ("nv", "nl", "nr", "rdst_part", "reach")


def share_graph(pg, directory, *, edge_layout: bool = True) -> Path:
    """Write ``pg`` (and its partition edge layout with the per-partition
    slices every rank's mesh layout is cut from) under ``directory`` as
    ``.npy`` files for ``load_shared_graph``."""
    from repro_torch.graph.partition import _mesh_part_slices, partitioned_edge_layout

    root = Path(directory)
    root.mkdir(parents=True, exist_ok=True)
    g = pg.graph
    meta = {
        "n_vertices": g.n_vertices, "n_parts": pg.n_parts,
        "weighted": g.weights is not None,
        "generation": int(pg.__dict__.get("_delta_generation", 0)),
        "edge_layout": bool(edge_layout),
    }
    np.save(root / "src.npy", g.src)
    np.save(root / "dst.npy", g.dst)
    np.save(root / "part.npy", pg.part_of_vertex)
    if g.weights is not None:
        np.save(root / "weights.npy", g.weights)
    if edge_layout:
        pel = partitioned_edge_layout(pg)
        for side in ("local", "remote"):
            csr = getattr(pel, side)
            for f in ("src", "dst", "weights", "perm"):
                np.save(root / f"pel_{side}_{f}.npy", getattr(csr, f))
        for f in ("local_part", "remote_src_part", "local_eid", "remote_eid"):
            np.save(root / f"pel_{f}.npy", getattr(pel, f))
        slices = _mesh_part_slices(pg)
        for f in _SLICE_GROUPS:
            groups = getattr(slices, f)
            np.save(root / f"sl_{f}.npy", np.concatenate(groups))
            np.save(root / f"sl_{f}_sizes.npy", np.array([g.size for g in groups]))
        for f in _SLICE_ARRAYS:
            np.save(root / f"sl_{f}.npy", getattr(slices, f))
    (root / "graph.json").write_text(json.dumps(meta))
    return root


def load_shared_graph(directory):
    """The ``PartitionedGraph`` ``share_graph`` wrote, its arrays mapped
    read-only, with the partition edge layout and its per-partition slices
    seeded into its caches."""
    from repro_torch.graph.partition import PartitionedEdgeLayout, _PartSlices
    from repro_torch.graph.structs import CsrEdgeLayout, Graph, PartitionedGraph

    root = Path(directory)
    meta = json.loads((root / "graph.json").read_text())

    def load(name):
        return np.load(root / f"{name}.npy", mmap_mode="r")

    n = meta["n_vertices"]
    g = Graph(n, load("src"), load("dst"), load("weights") if meta["weighted"] else None)
    pg = PartitionedGraph(g, meta["n_parts"], load("part"))
    if meta["generation"]:
        pg.__dict__["_delta_generation"] = meta["generation"]
    if meta["edge_layout"]:
        sides = {
            side: CsrEdgeLayout(
                n, *(load(f"pel_{side}_{f}") for f in ("src", "dst", "weights", "perm"))
            )
            for side in ("local", "remote")
        }
        pg.__dict__["_edge_layout"] = PartitionedEdgeLayout(
            **sides, **{f: load(f"pel_{f}") for f in (
                "local_part", "remote_src_part", "local_eid", "remote_eid")},
        )
        groups = {
            f: np.split(load(f"sl_{f}"), np.cumsum(np.load(root / f"sl_{f}_sizes.npy"))[:-1])
            for f in _SLICE_GROUPS
        }
        pg.__dict__["_mesh_part_slices"] = _PartSlices(
            **groups, **{f: load(f"sl_{f}") for f in _SLICE_ARRAYS}
        )
    return pg
