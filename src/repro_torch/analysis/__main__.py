"""CLI for the port's analysis layer.

Modes::

    python -m repro_torch.analysis [--device cuda|cpu]   # lint + full window audit
    python -m repro_torch.analysis --lint [PATH..]       # AST lint only
    python -m repro_torch.analysis --fixtures [--device]  # known-bad corpus: all must flag

The audit runs on the card by default; ``--device cpu`` runs it on the CPU
(the plain versions, no CUDA backend), and a CUDA device without CUDA
raises.  Exit status is 0 iff the run is clean (for ``--fixtures``: iff
every fixture is flagged).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

#: what the lint covers by default: this package's own tree
PACKAGE_DIR = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="window auditor + AST lint of the PyTorch/CUDA port",
    )
    parser.add_argument(
        "--fixtures", action="store_true",
        help="run the seeded known-bad corpus; fail unless 100%% is flagged",
    )
    parser.add_argument(
        "--lint", nargs="*", metavar="PATH",
        help="AST lint only, over the given paths (default: src/repro_torch)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the audit runs: cuda (default, the card) or cpu",
    )
    args = parser.parse_args(argv)

    from repro_torch.analysis.findings import render
    from repro_torch.analysis.lint import lint_paths

    if args.lint is not None:
        findings = lint_paths(args.lint or [PACKAGE_DIR])
        out = render(findings)
        if out:
            print(out)
        print(f"lint: {len(findings)} finding(s)")
        return 1 if findings else 0

    from repro_torch.graph.config import resolve_device

    device = resolve_device(args.device)  # a CUDA device without CUDA raises
    if args.fixtures:
        from repro_torch.analysis.fixtures import run_fixtures

        results = run_fixtures(device)
        missed = [r for r in results if not r.flagged]
        for r in results:
            tick = "flagged" if r.flagged else "MISSED"
            print(f"[{tick}] {r.fixture.rule} {r.fixture.name}: {r.fixture.description}")
        print(f"{len(results) - len(missed)}/{len(results)} fixtures flagged")
        return 1 if missed else 0

    from repro_torch.analysis.trace_audit import audit_tree

    findings = lint_paths([PACKAGE_DIR]) + audit_tree(device=device)
    out = render(findings)
    if out:
        print(out)
    print(f"analysis: {len(findings)} finding(s) on {device}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
