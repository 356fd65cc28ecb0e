"""The port's analysis layer (``repro_torch.analysis``) on the CPU.

Green side: ``audit_tree(device="cpu")`` -- every builtin program on the
``torch`` backend, dense and on 4 gloo ranks, unmirrored and mirrored, the
relayout sweep, the layout budgets and the delta cycle, in one ``run_ranks``
launch -- finds nothing, and the port's lint over ``src/repro_torch`` finds
nothing.  Red side: every fixture of the known-bad corpus is flagged with
its rule id and message, and each control (an extra ``.item()`` in a
window, a rank that skips one ``all_to_all``, a wrapper that leaves rows
unwritten) fails its check.  Held against the JAX package's analyzers on
the same inputs: JX05 verdicts, the cache-key probes' rule ids, the AST
rules' ids and lines on the reference's own fixture sources, and the
layout-budget sweep's distinct keys.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import fixtures as ref_fixtures
from repro.analysis import jaxpr_audit as ref_audit
from repro.analysis.lint import lint_source as ref_lint_source
from repro.graph import partition as ref_partition
from repro.graph import program as ref_program
from repro.graph.structs import mesh_layout_key as ref_mesh_layout_key
from repro_torch.analysis import __main__ as analysis_main
from repro_torch.analysis import trace_audit
from repro_torch.analysis.findings import RULES, Finding, render
from repro_torch.analysis.fixtures import ALL_FIXTURES, run_fixtures, simulated_window_findings
from repro_torch.analysis.lint import lint_paths, lint_source
from repro_torch.analysis.registry import AUDIT_MESH_WIDTH, AUDIT_MIRROR_DEGREE, HOT_PATH_FUNCTIONS
from repro_torch.graph.program import BUILTIN_PROGRAMS
from repro_torch.graph.structs import mesh_layout_key

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
PROGRAM_NAMES = sorted(BUILTIN_PROGRAMS)


@pytest.fixture(scope="module")
def tree():
    """The whole CPU audit, run once: ``(findings, summary)``."""
    summary = {}
    findings = trace_audit.audit_tree(device="cpu", summary=summary)
    return findings, summary


@pytest.fixture(scope="module")
def pg():
    return trace_audit.default_audit_graph()


# -- green: the tree audits clean ------------------------------------------------


@pytest.mark.mesh
@pytest.mark.parametrize("engine", ["dense", "mesh", "mesh-mirrored"])
@pytest.mark.parametrize("name", PROGRAM_NAMES)
def test_audit_tree_is_clean(tree, name, engine):
    findings, summary = tree
    if engine == "dense":
        prefix = f"dense/{name}/torch/"
        rows = summary["dense"][f"{name}/torch"]
        assert rows[0]["reads"] > 0 and rows[0]["transfers_per_pull"] == 7
    else:
        tag = f"/mirror{AUDIT_MIRROR_DEGREE}" if engine == "mesh-mirrored" else ""
        prefix = f"mesh/{name}/torch/d{AUDIT_MESH_WIDTH}{tag}/"
        (case,) = [c for c in summary["mesh"]["cases"] if c["label"] + "/" == prefix]
        assert case["mirrored"] == (engine == "mesh-mirrored")
        assert case["collectives"] > 0
        rows = case["stats_rank0"]
    # every window runs supersteps: the later one is audited on real work
    assert len(rows) == len(trace_audit.AUDIT_WINDOWS) > 1
    assert all(r["inner_iters"] > 0 and r["launches"] == 0 for r in rows), rows
    assert all(r["partition_launches"] == 0 for r in rows[1:]), rows
    mine = [f for f in findings if f.where.startswith(prefix)]
    assert not mine, render(mine)


@pytest.mark.mesh
def test_audit_tree_budgets_and_sweep_clean(tree):
    findings, summary = tree
    assert not findings, render(findings)
    assert summary["mesh"]["ranks"] == AUDIT_MESH_WIDTH
    for sweep in summary["mesh"]["sweep"]:
        assert sweep["builds"] == sweep["placements"] == 2
        assert sweep["swaps"] == sweep["map_changes"] == 3


def test_lint_clean_on_the_port():
    findings = lint_paths([PKG])
    assert not findings, render(findings)


def test_lint_does_not_flag_a_shape_branch_the_reference_flags():
    """``relax_blockmap_call`` branches on ``cand.shape``: legal in eager
    PyTorch, an AL01 hit under the reference's rules."""
    path = "src/repro_torch/kernels/bfs_relax/ops.py"
    source = (ROOT / path).read_text()
    line = next(i for i, s in enumerate(source.splitlines(), 1) if "cand.shape[1] == 0" in s)
    ref = ref_lint_source(source, path, traced_overrides=[
        ("relax_blockmap_call", ("row_ptr", "dst", "cand", "base"))
    ])
    assert [(f.rule, f.where) for f in ref] == [("AL01", f"{path}:{line}")]
    assert lint_source(source, path) == []


@pytest.mark.parametrize("path, old, new", [
    ("graph/traversal.py", "ident = self._identity", "ident = prog.identity.item()"),
    ("graph/traversal.py", "torch.where(live_t, fresh.dist, self._identity)",
     "torch.where(live_t, fresh.dist, self.program.identity.item())"),
    ("graph/mesh_exchange.py", "ident = self._identity", "ident = prog.identity.item()"),
    ("graph/mesh_exchange.py", "if not read_any(fr):",
     "if not bool(mesh.all_reduce(fr.any().reshape(1).to(i32), 'max').item()):"),
])
def test_lint_flags_the_reads_the_repair_removed(path, old, new):
    """The hot-path reads read before the repair are AL01 hits at their
    line, under the port's own rules."""
    source = (PKG / path).read_text()
    assert source.count(old) == 1
    bad = source.replace(old, new)
    line = next(i for i, s in enumerate(bad.splitlines(), 1) if new in s)
    findings = lint_source(bad, f"src/repro_torch/{path}")
    assert [(f.rule, f.where.rsplit(":", 1)[1]) for f in findings] == [("AL01", str(line))]
    assert "uncounted host read" in findings[0].message


@pytest.mark.parametrize("snippet, flagged", [
    ("if cand.shape[0] == 0 or cand.dtype != base.dtype:\n        return base", False),
    ("n = int(cand.numel())", False),
    ("if cand is None:\n        return base", False),
    ("if self._any(cand):\n        return base", False),
    ("while self._any(cand) and _to_host(base)[0] > 0:\n        base = base - 1", False),
    ("rows = np.unique(host_rows)", False),
    ("out = torch.repeat_interleave(cand, counts, output_size=9)", False),
    ("if cand.any():\n        return base", True),
    ("x = cand.sum().item()", True),
    ("x = cand.tolist()", True),
    ("x = float(base.max())", True),
    ("x = np.asarray(cand)", True),
    ("x = cand.nonzero()", True),
    ("x = torch.unique(cand)", True),
    ("x = torch.where(cand > 0)", True),
    ("x = torch.repeat_interleave(cand, counts)", True),
    ("x = cand[cand > 0]", True),
    ("x = base[~mask]", True),
    ("while base.min() > 0:\n        base = base - 1", True),
    # a counted helper's arguments are linted like any other expression
    ("if self._any(cand.sum().item() > 0):\n        return base", True),
    ("if self._any(bool(cand.max())):\n        return base", True),
    # a counted helper counts only in the form and file it is defined in
    ("if _any(cand):\n        return base", True),
    ("if read_any(cand):\n        return base", True),
])
def test_lint_hot_path_rule(snippet, flagged):
    """Hot-path reads in a function linted as if it were in
    ``graph/traversal.py``, whose counted helpers are ``self._any`` and
    ``_to_host``."""
    body = "\n".join("    " + ln for ln in snippet.splitlines())
    source = (
        "import numpy as np\nimport torch\n\n_USED = (np, torch)\n\n\n"
        f"def hot(self, cand, base, host_rows, counts, mask):\n{body}\n    return base\n"
    )
    findings = lint_source(source, "fixture/graph/traversal.py",
                           hot_overrides=[("hot", ("cand", "base"))])
    assert [f.rule for f in findings] == (["AL01"] if flagged else []), render(findings)


def test_lint_skips_only_the_counted_helpers_own_body():
    """A helper named like a counted one in another file is linted as hot
    path; the real helper nested in the mesh window is not."""
    source = (
        "def window(self, dist, frontier, nst0):\n"
        "    def read_any(t):\n        return bool(t.any().item())\n"
        "    return read_any(frontier)\n"
    )
    assert lint_source(source, "src/repro_torch/graph/mesh_exchange.py") == []
    findings = lint_source(source, "fixture/elsewhere.py",
                           hot_overrides=[("window", ("dist", "frontier", "nst0"))])
    assert [f.rule for f in findings] == ["AL01"], render(findings)
    assert "'.item()'" in findings[0].message


def test_registry_names_functions_that_exist():
    for fn in HOT_PATH_FUNCTIONS:
        tree_ = ast.parse((PKG / fn.file_suffix).read_text())
        defs = [n for n in ast.walk(tree_) if isinstance(n, ast.FunctionDef) and n.name == fn.name]
        assert defs, fn
        params = {a.arg for d in defs for a in d.args.args}
        assert set(fn.array_params) <= params, fn


# -- red: the known-bad corpus is 100% flagged ------------------------------------


@pytest.mark.parametrize("fixture", ALL_FIXTURES, ids=[f.name for f in ALL_FIXTURES])
def test_fixture_is_flagged(fixture):
    findings = fixture.run("cpu")
    hits = [f for f in findings if f.rule == fixture.rule and fixture.must_match in f.message]
    assert hits, render(findings)


def test_corpus_keeps_the_reference_classes():
    assert len(ALL_FIXTURES) == len(ref_fixtures.ALL_FIXTURES) == 11
    ref_rules = sorted(f.rule for f in ref_fixtures.ALL_FIXTURES)
    assert sorted(f.rule for f in ALL_FIXTURES) == ref_rules
    assert {f.rule for f in ALL_FIXTURES} <= set(RULES)


def test_findings_reject_unknown_rule():
    with pytest.raises(ValueError, match="unknown rule"):
        Finding("ZZ99", "nowhere.py:1", "no such rule")


def test_cli_fixtures_mode_exits_zero(capsys):
    assert analysis_main.main(["--fixtures", "--device", "cpu"]) == 0
    assert "11/11 fixtures flagged" in capsys.readouterr().out


def test_cli_lint_mode_exits_zero(capsys):
    assert analysis_main.main(["--lint"]) == 0
    assert "lint: 0 finding(s)" in capsys.readouterr().out


@pytest.mark.mesh
def test_cli_full_mode_reports_the_audit(tree, capsys, monkeypatch):
    """The default mode: lint + ``audit_tree`` on the given device (the
    audit's own run is the module fixture's; the CLI is held to it)."""
    seen = []
    monkeypatch.setattr(trace_audit, "audit_tree",
                        lambda device: seen.append(device) or list(tree[0]))
    assert analysis_main.main(["--device", "cpu"]) == 0
    assert seen == [torch.device("cpu")]
    assert "analysis: 0 finding(s) on cpu" in capsys.readouterr().out


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot show here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analysis_main.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analysis_main.main(["--fixtures"])


@pytest.mark.parametrize("entry", [
    lambda pg: trace_audit.audit_tree(pg),
    lambda pg: trace_audit.audit_dense(pg, BUILTIN_PROGRAMS["bfs"](), "torch"),
    lambda pg: trace_audit.audit_mesh_matrix(pg),
    lambda pg: trace_audit.control_extra_read(pg, "torch"),
    lambda pg: run_fixtures(),
], ids=["audit_tree", "audit_dense", "audit_mesh_matrix", "control_extra_read", "run_fixtures"])
def test_entry_points_default_to_the_card(pg, entry):
    """Left without ``device``, every public entry point audits on the card:
    without CUDA it raises, and never audits the plain path on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot show here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(pg)


# -- controls -----------------------------------------------------------------


def test_extra_item_in_a_window_fails_jx01(pg):
    findings = trace_audit.control_extra_read(pg, "torch", device="cpu")
    assert [f.rule for f in findings] == ["JX01"], render(findings)
    assert "1 uncounted host read" in findings[0].message


@pytest.mark.parametrize("skip_rank", [None, 1])
def test_rank_skipping_one_all_to_all_fails_jx02(skip_rank):
    findings = simulated_window_findings(
        "control/skip", {"all_to_all": 1, "psum": 0, "pmax_boundary": 1, "pmax_closure": 2},
        skip_rank=skip_rank,
    )
    if skip_rank is None:
        assert findings == []
    else:
        assert any("rank-conditional" in f.message and "rank 1" in f.message
                   for f in findings), render(findings)
        assert {f.rule for f in findings} == {"JX02"}


def test_poison_check_passes_the_plain_versions_and_catches_a_skip():
    findings, rows = trace_audit.audit_poisoned_kernels("cpu")
    assert not findings, render(findings)
    assert len(rows) == 7 and all(r["landed"] for r in rows)
    fx = next(f for f in ALL_FIXTURES if f.rule == "AL03")
    assert any("poisoned memory" in f.message for f in fx.run("cpu"))


@pytest.mark.parametrize("op, flagged", [
    (lambda x: x[x > 2], True),
    (lambda x: x.nonzero(), True),
    (lambda x: torch.unique(x), True),
    (lambda x: x.masked_select(x > 2), True),
    (lambda x: torch.repeat_interleave(torch.tensor([1, 2])), True),
    (lambda x: torch.repeat_interleave(torch.tensor([1, 2]), output_size=3), False),
    (lambda x: torch.where(x > 2, x, 0.0), False),
    (lambda x: x.index_select(0, torch.tensor([1, 2])), False),
], ids=["mask-index", "nonzero", "unique", "masked_select", "repeat", "repeat-sized",
        "where", "index_select"])
def test_data_dependent_ops_on_the_hot_path_fail_jx01(op, flagged):
    log = trace_audit.OpLog()
    with log:
        op(torch.arange(6.0))
    findings = trace_audit.check_host_traffic(
        log, "control/op", reads_counted=0, pulls_counted=0, transfers=0
    )
    assert bool(findings) == flagged, render(findings)
    assert all("data-dependent-shape op" in f.message for f in findings)


# -- held against the JAX package -------------------------------------------------


def test_audit_graph_is_the_reference_audit_graph(pg):
    ref = ref_audit.default_audit_graph()
    for a, b in ((ref.graph.src, pg.graph.src), (ref.graph.dst, pg.graph.dst),
                 (ref.graph.weights, pg.graph.weights), (ref.part_of_vertex, pg.part_of_vertex)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", PROGRAM_NAMES)
def test_identity_verdict_matches_reference(name):
    ours = trace_audit.check_identity(BUILTIN_PROGRAMS[name](), name)
    ref = ref_audit.check_identity(ref_program.BUILTIN_PROGRAMS[name](), name)
    assert [f.rule for f in ours] == [f.rule for f in ref] == []


@pytest.mark.parametrize("which", ["canonical", "raw-tobytes"])
def test_cache_key_probe_matches_reference(which):
    if which == "canonical":
        ours_fn, ref_fn = mesh_layout_key, ref_mesh_layout_key
    else:
        ours_fn = ref_fn = lambda dmap, n_devices: (int(n_devices), dmap.tobytes())  # noqa: E731
    ours = trace_audit.check_cache_key_fn(ours_fn, which)
    ref = ref_audit.check_cache_key_fn(ref_fn, which)
    assert [f.rule for f in ours] == [f.rule for f in ref]
    assert bool(ours) == (which == "raw-tobytes")


_SRC_UNUSED_IMPORT = '''\
import os
import numpy as np


def f(x):
    return np.asarray(x)
'''


@pytest.mark.parametrize("which", ["AL02", "AL04", "AL05"])
def test_source_rules_match_reference(which):
    source = {
        "AL02": ref_fixtures._SRC_UNBOUNDED_CACHE,
        "AL04": ref_fixtures._SRC_BYTES_KEY,
        "AL05": _SRC_UNUSED_IMPORT,
    }[which]
    path = f"fixture/{which.lower()}.py"
    ours = [(f.rule, f.where) for f in lint_source(source, path)]
    ref = [(f.rule, f.where) for f in ref_lint_source(source, path)]
    assert ours == ref and [r for r, _ in ours] == [which]


@pytest.mark.parametrize("rotations, degrees", [
    ((0, 1, 0, 1), (None,)),
    ((0,), (None, AUDIT_MIRROR_DEGREE, None)),
], ids=["placements", "mirror-knob"])
def test_budget_sweep_keys_match_reference(pg, rotations, degrees):
    ours = trace_audit.sweep_layouts(pg, d_n=4, rotations=rotations, mirror_degrees=degrees)
    ref_pg = ref_audit.default_audit_graph()
    base = ref_partition.contiguous_device_map(ref_pg.n_parts, 4)
    ref_keys = {
        ref_partition.mesh_edge_layout(ref_pg, np.roll(base, r), 4, mirror_degree=md).layout_key
        for r in rotations for md in degrees
    }
    assert ours["layout_keys"] == ref_keys
    assert ours["builds"] == ours["cache_size"] == len(ref_keys)
    assert ref_audit.audit_recompile_budget(
        ref_pg, None, backend="xla", d_n=4, windows=(1, 8, 1), rotations=rotations,
        mirror_degrees=degrees,
    ) == []
    assert trace_audit.audit_recompile_budget(
        pg, d_n=4, rotations=rotations, mirror_degrees=degrees
    ) == []
