"""The seeded known-bad corpus (the port of ``repro.analysis.fixtures``):
every bug class the analyzers exist for, rebuilt in PyTorch, and required
to be flagged.

Each fixture keeps the reference's rule id and runs its defect through the
SAME checker the live audit uses (never a fixture-only code path),
asserting at least one finding with the expected rule id and message
substring.  The mesh fixtures run a window shaped like
``MeshTraversalProgram.window`` once per simulated rank against a
``SimulatedMesh`` in one process -- no rank is started, so none can
deadlock.  ``--fixtures`` mode (and ``tests/test_torch_analysis.py``) fails
unless 100% of the corpus is flagged: the proof that a clean audit is clean
because the tree is, not because the checkers are blind.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.lint import lint_source
from repro_torch.analysis.trace_audit import (
    OpLog,
    check_cache_key_fn,
    check_host_traffic,
    check_poisoned_output,
    check_rank_logs,
    check_window_collectives,
    collective_log,
    grid_findings,
    simulated_mesh,
)
from repro_torch.graph.config import resolve_device
from repro_torch.kernels.bfs_relax.ref import relax_reference

_D = 4  # simulated mesh width of the SPMD fixtures
_STEPS = 3  # supersteps of a mini window (its m_max)


@dataclasses.dataclass(frozen=True)
class Fixture:
    name: str
    rule: str  # the rule that must fire
    must_match: str  # substring required in at least one finding's message
    description: str
    run: callable  # (device) -> list[Finding]


@dataclasses.dataclass(frozen=True)
class FixtureResult:
    fixture: Fixture
    findings: list
    flagged: bool


# -- JX04: the stale layout-cache key -----------------------------------------


def _fx_stale_tobytes_cache(device):
    """The original layout-cache key: raw uncoerced ``tobytes()`` --
    dtype-sensitive AND lets two different maps alias one buffer."""
    legacy_key = lambda dmap, n_devices: (int(n_devices), dmap.tobytes())  # noqa: E731
    return check_cache_key_fn(legacy_key, "fixture/stale-tobytes-key")


# -- JX03: the zero-size grid -------------------------------------------------


def _legacy_grid(n: int, e: int, block_n: int, block_e: int) -> tuple[int, int]:
    """A block-tiled launch grid WITHOUT the clamp on the edge axis: an
    empty edge shard gives ``e_pad == 0`` and a zero-size grid dimension."""
    bn = max(8, min(block_n, n))
    n_pad = -(-n // bn) * bn
    be = min(block_e, e)
    e_pad = -(-e // be) * be if be else 0
    return n_pad // bn, e_pad // be if be else 0


def _fx_zero_size_grid(device):
    return grid_findings([_legacy_grid(16, 0, 512, 512)], "fixture/zero-size-grid")


# -- JX02: collective defects on a simulated mesh -----------------------------


def _mini_window(
    mesh, x: torch.Tensor, *, mirrored: bool = False, drop_epilogue: bool = False,
    drop_mirror_sync: bool = False, skip_rank: int | None = None, local_cond: bool = False,
):
    """A window shaped like the mesh window on ``[2, D * 8]`` rows: each
    superstep is its condition (an ``all_reduce(max)`` read on the host), a
    boundary sync, one closure iteration (a sync and its loop condition's
    read) and the exchange ``all_to_all`` (two when mirrored); the window
    ends in the counter ``all_reduce(sum)``.  Each flag plants one defect."""
    i32 = torch.int32

    def read_any(t) -> bool:
        return bool(mesh.all_reduce(t.any().reshape(1).to(i32), "max").item())

    def exchange(v):
        return torch.minimum(v, mesh.all_to_all(v.reshape(2, mesh.world_size, -1).transpose(0, 1)
                                                ).transpose(0, 1).reshape(v.shape))

    counters = torch.zeros(2, dtype=i32)
    s = 0
    while s < _STEPS:
        go = bool(x.any()) if local_cond else read_any(x > 0)
        if not go:
            break
        counters = counters + mesh.all_reduce((x > 0).any(dim=1).to(i32), "max")
        mesh.all_reduce((x > 0).any(dim=1).to(i32), "max")  # the closure's sync
        read_any(torch.zeros(1, dtype=torch.bool))  # its loop condition: done
        if not (skip_rank == mesh.rank and s == 1):
            x = exchange(x)
        if mirrored and not drop_mirror_sync:
            x = exchange(x)
        s += 1
    if not drop_epilogue:
        counters = mesh.all_reduce(counters, "sum")
    return x, counters


_MINI_SIG = {"all_to_all": 1, "psum": 0, "pmax_boundary": 1, "pmax_closure": 2}
_MINI_SIG_MIRRORED = dict(_MINI_SIG, all_to_all=2)


def simulated_window_findings(label: str, signature: dict, **defects) -> list:
    """Run ``_mini_window`` on each of ``_D`` simulated ranks under the op
    log and check it as the live mesh audit does: each rank's window
    against ``signature``, and the ranks' collective logs against each
    other."""
    findings, logs = [], []
    for rank in range(_D):
        mesh = simulated_mesh(_D, rank)
        log = OpLog()
        mesh.tap["log"] = log
        x = torch.arange(1, 2 * _D * 8 + 1, dtype=torch.float32).reshape(2, -1)
        with log:
            _mini_window(mesh, x, **defects)
        where = f"{label}/rank{rank}"
        findings += check_window_collectives(log.events, signature, where, m_max=_STEPS)
        logs.append(collective_log(log.events))
    return findings + check_rank_logs(logs, label)


def _checked_twin(label: str, signature: dict, **flags) -> None:
    """The intact twin of a defect must audit clean through the same
    checker: the fixture shows the checker fires on the defect, not on the
    window's shape."""
    clean = simulated_window_findings(f"{label}-control", signature, **flags)
    if clean:
        raise RuntimeError(f"control window must audit clean, got {clean}")


def _fx_dropped_psum(device):
    _checked_twin("fixture/dropped-psum", _MINI_SIG)
    return simulated_window_findings("fixture/dropped-psum", _MINI_SIG, drop_epilogue=True)


def _fx_dropped_mirror_sync(device):
    _checked_twin("fixture/dropped-mirror-sync", _MINI_SIG_MIRRORED, mirrored=True)
    return simulated_window_findings(
        "fixture/dropped-mirror-sync", _MINI_SIG_MIRRORED, mirrored=True, drop_mirror_sync=True,
    )


def _fx_conditional_collective(device):
    return simulated_window_findings("fixture/conditional-collective", _MINI_SIG, skip_rank=1)


def _fx_unsynced_loop(device):
    return simulated_window_findings("fixture/unsynced-loop", _MINI_SIG, local_cond=True)


# -- JX01: an uncounted host read ---------------------------------------------


def _fx_host_callback(device):
    """A debug print of a device value inside a window: a host read the
    engine does not count."""
    debug = []

    def bad_window(dist):
        debug.append(f"frontier size {(dist < float('inf')).sum().item()}")
        return dist * 2.0

    log = OpLog()
    with log:
        bad_window(torch.arange(8, dtype=torch.float32))
    return check_host_traffic(
        log, "fixture/host-callback", reads_counted=0, pulls_counted=0, transfers=0,
    )


# -- AL03: an output the kernel leaves unwritten --------------------------------


def _fx_uninitialized_output(device):
    """A wrapper that returns ``torch.empty`` rows which its kernel skips
    (rows without edges keep no ``combine(base, identity)``), run into
    poisoned memory against the plain version."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    n, e = 64, 96
    dst = torch.sort(torch.randint(0, n // 2, (e,), generator=gen) * 2).values  # odd rows empty
    row_ptr = torch.searchsorted(dst, torch.arange(n + 1)).to(torch.int32)
    cand = torch.rand((2, e), generator=gen).to(device)
    base = torch.rand((2, n), generator=gen).to(device)
    dst_d, row_ptr_d = dst.to(device), row_ptr.to(device)

    def skipping_wrapper():
        out = torch.empty_like(base)
        hit = (row_ptr_d[1:] > row_ptr_d[:-1]).nonzero().flatten()
        full = relax_reference(dst_d, cand, base, "min")
        out[:, hit] = full[:, hit]  # rows without edges are never written
        return out

    plain = relax_reference(dst_d, cand, base, "min")
    findings, _ = check_poisoned_output(
        "fixture/uninitialized-output", skipping_wrapper,
        lambda out: (torch.equal(out, plain), float((out != plain).sum())),
        device=device, out_nbytes=base.numel() * base.element_size(),
    )
    return findings


# -- AL01/AL02/AL04: source-level reconstructions -----------------------------

_SRC_NUMPY_IN_HOT_PATH = '''\
import torch


def window_step(dist, frontier):
    mask = np.asarray(frontier)
    if frontier.any():
        dist = dist + float(dist.min())
    live = dist[dist < 1e9]
    return torch.where(torch.from_numpy(mask), dist, live.sum().item())
'''

_SRC_UNBOUNDED_CACHE = '''\
_LAYOUTS = {}


def get_layout(key, build):
    if key not in _LAYOUTS:
        _LAYOUTS[key] = build()
    return _LAYOUTS[key]
'''

_SRC_BYTES_KEY = '''\
def layout_cache_key(device_of_part, n_devices):
    return (int(n_devices), device_of_part.tobytes())
'''


def _fx_numpy_in_hot_path(device):
    return lint_source(
        _SRC_NUMPY_IN_HOT_PATH, "fixture/numpy_in_hot_path.py",
        hot_overrides=[("window_step", ("dist", "frontier"))],
    )


def _fx_unbounded_cache(device):
    return lint_source(_SRC_UNBOUNDED_CACHE, "fixture/unbounded_cache.py")


def _fx_bytes_key(device):
    return lint_source(_SRC_BYTES_KEY, "fixture/bytes_key.py")


ALL_FIXTURES = (
    Fixture(
        "stale-tobytes-cache-key", "JX04", "alias",
        "the raw-tobytes layout-cache key (dtype-blind, buffer-aliasing)",
        _fx_stale_tobytes_cache,
    ),
    Fixture(
        "zero-size-grid", "JX03", "grid dimension",
        "an unclamped block grid: an empty edge shard -> a 0-size grid dim",
        _fx_zero_size_grid,
    ),
    Fixture(
        "dropped-psum", "JX02", "epilogue",
        "a window returns per-rank counters without their epilogue sum",
        _fx_dropped_psum,
    ),
    Fixture(
        "dropped-mirror-sync", "JX02", "superstep-boundary collectives",
        "a mirrored window whose mirror->owner all_to_all was dropped while "
        "the signature still declares it",
        _fx_dropped_mirror_sync,
    ),
    Fixture(
        "conditional-collective", "JX02", "rank-conditional",
        "rank 1 skips one exchange all_to_all: the other ranks would deadlock",
        _fx_conditional_collective,
    ),
    Fixture(
        "unsynced-loop", "JX02", "device-local",
        "a superstep loop whose condition is a rank-local any",
        _fx_unsynced_loop,
    ),
    Fixture(
        "host-callback", "JX01", "uncounted host read",
        "a debug print of a device value (.item()) inside a window",
        _fx_host_callback,
    ),
    Fixture(
        "numpy-in-hot-path", "AL01", "pulls it to the host",
        "np.asarray / .item() / float() / a Python if / a mask gather over "
        "window tensors",
        _fx_numpy_in_hot_path,
    ),
    Fixture(
        "unbounded-cache", "AL02", "without a bound",
        "module-level dict cache growing forever",
        _fx_unbounded_cache,
    ),
    Fixture(
        "uninitialized-kernel-output", "AL03", "poisoned memory",
        "a wrapper returning torch.empty rows its kernel skips",
        _fx_uninitialized_output,
    ),
    Fixture(
        "bytes-cache-key-source", "AL04", "tobytes",
        "source-level twin of the stale cache key: tobytes without shape/dtype",
        _fx_bytes_key,
    ),
)


def run_fixtures(device="cuda") -> list[FixtureResult]:
    """Run the whole corpus; a fixture is flagged iff some finding carries
    its rule id AND its pinned message substring.  ``device`` is where the
    uninitialized-output fixture runs its wrapper (the card by default, into
    the caching allocator's poisoned blocks; a CUDA device without CUDA
    raises); the rest run on the CPU."""
    device = resolve_device(device)
    results = []
    for fx in ALL_FIXTURES:
        findings = fx.run(device)
        flagged = any(f.rule == fx.rule and fx.must_match in f.message for f in findings)
        results.append(FixtureResult(fx, findings, flagged))
    return results
