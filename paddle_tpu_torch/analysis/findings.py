"""Structured findings for the static-analysis subsystem.

Counterpart of ``paddle_tpu/analysis/findings.py``, the same records and
the same rendered text. A ``Finding`` is one rule violation with
provenance (``file:line``), the currency every level of
``paddle_tpu_torch.analysis`` trades in: the program passes emit them for
hazards in one traced program, the source lint for trace-safety
violations in the source, and the choke points
(``serving.Engine.check_programs``, the fleet's spawn gate, the
self-lint gate) decide what to do with them.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

__all__ = ["Severity", "Finding", "Report", "AnalysisError"]


class Severity(enum.IntEnum):
    """Ordered so choke points can threshold (``>= WARNING``)."""

    INFO = 0
    WARNING = 1
    ERROR = 2


@dataclass
class Finding:
    """One rule violation.

    rule:     stable kebab-case rule id (the contract tests assert on).
    severity: Severity (orderable).
    message:  human-readable description of the hazard.
    file:     source file of the offending code, or None when the
              provenance could not be recovered (e.g. REPL lambdas).
    line:     1-indexed line in ``file``.
    op:       the traced op (``mul``, ``kernel:paged_attention/cluster``)
              for program findings, None for source findings.
    root:     the entry point the finding was reached FROM (e.g.
              ``"serving.decode"`` for an engine program). ``file:line``
              names the offending call site, usually deep inside an
              adapter or op body, while ``root`` names the program that
              pulls it onto a hot path, so a rendered finding carries
              both.
    """

    rule: str
    severity: Severity
    message: str
    file: str | None = None
    line: int | None = None
    op: str | None = None
    root: str | None = None

    def location(self):
        if self.file is None:
            return "<unknown>"
        return f"{self.file}:{self.line}" if self.line else self.file

    def render(self):
        tag = self.severity.name.lower()
        ops = f" [{self.op}]" if self.op else ""
        via = f" (root: {self.root})" if self.root else ""
        return (
            f"{self.location()}: {tag}: {self.rule}{ops}{via}: "
            f"{self.message}"
        )


@dataclass
class Report:
    """Ordered finding collection returned by ``analysis.check`` and the
    lint entry points."""

    findings: list = field(default_factory=list)

    def add(self, finding):
        self.findings.append(finding)

    def extend(self, findings):
        self.findings.extend(findings)

    def by_rule(self, rule):
        return [f for f in self.findings if f.rule == rule]

    def at_least(self, severity):
        return [f for f in self.findings if f.severity >= severity]

    @property
    def errors(self):
        return self.at_least(Severity.ERROR)

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == Severity.WARNING]

    def __iter__(self):
        return iter(self.findings)

    def __len__(self):
        return len(self.findings)

    def render(self):
        if not self.findings:
            return "analysis: clean (0 findings)"
        lines = [f.render() for f in self.findings]
        lines.append(f"analysis: {len(self.findings)} finding(s)")
        return "\n".join(lines)


class AnalysisError(RuntimeError):
    """Raised by ``check="error"`` choke points: carries the report so
    callers can still inspect the structured findings."""

    def __init__(self, message, report=None):
        super().__init__(message)
        self.report = report
