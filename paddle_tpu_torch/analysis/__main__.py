"""CLI: ``python -m paddle_tpu_torch.analysis --self`` (the CI self-check
gate) or ``python -m paddle_tpu_torch.analysis path [path ...]`` to lint
arbitrary files/trees.

Exit codes (the stable contract of ``python -m paddle_tpu.analysis``):

    0   clean — the lint ran and produced an EMPTY findings list
    1   findings — the lint ran and produced one or more findings
        (including ``parse-error`` findings for unreadable sources)
    2   usage error — bad arguments (argparse's convention), nothing
        was linted

A clean run always prints the ``analysis: clean (0 findings)`` summary
line, so "no output" can never be confused with "did not run".
"""
from __future__ import annotations

import argparse
import sys

from .astlint import lint_paths, package_root, self_lint
from .findings import Report

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis",
        description=(
            "trace-safety lint (level-2 AST rules); exit 0 clean, "
            "1 findings, 2 usage error"
        ),
    )
    parser.add_argument(
        "--self", action="store_true", dest="self_check",
        help="lint the installed paddle_tpu_torch package (the tier-1 gate)",
    )
    parser.add_argument("paths", nargs="*", help="files or directories")
    args = parser.parse_args(argv)
    if args.self_check:
        findings = self_lint()
    elif args.paths:
        findings = lint_paths(args.paths, base=package_root())
    else:
        parser.error("give --self or at least one path")  # exits 2
    report = Report(findings)
    print(report.render())
    return EXIT_FINDINGS if findings else EXIT_CLEAN


if __name__ == "__main__":
    sys.exit(main())
