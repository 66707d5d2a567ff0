"""paddle_tpu_torch.analysis — trace-safety linter and program analyzer.

Counterpart of ``paddle_tpu.analysis``, with its ``__all__``. The
correctness invariants of the port's serving path live in its captured
programs: one capture per program, a replay every step, no host sync
inside. This package makes them checkable BEFORE anything is captured.

Three levels:

  * L1 ``analysis.check(fn, *args)`` — run ``fn`` over fake tensors
    (``torch._subclasses.fake_tensor``: shapes, dtypes and devices, no
    memory, no kernel; the hand-kernel wrappers record one
    ``kernel:<name>/<variant>`` node each) and run pluggable passes over
    the op record: capture hazards (``retrace-hazard``), dtype drift,
    host-sync points, const bloat, dead outputs (``donation-misuse`` is
    registered and finds nothing: the pools are written in place by
    design).
  * L2 ``python -m paddle_tpu_torch.analysis --self`` — AST trace-safety
    lint over the port's own source (JAX's rules, with torch's sync
    points), a tier-1 gate. Exit codes 0/1/2 (clean/findings/usage).
  * L3 ``analysis.check_compiled(fn, *args)`` — the collective census
    and the per-device memory budget gate (``memory-budget``) over the
    same trace: the predicted peak is the bytes of the program's live
    tensors. Nothing runs.

Choke points: ``serving.Engine.check_programs()`` runs L1 + L3 over the
whole serving program family (with ``EngineConfig(device_memory_budget=)``
refusing a predicted-OOM config before the KV pool allocates);
``serving.FleetConfig(analysis_check=)`` gates every replica spawn;
``tests/test_torch_analysis.py::test_self_lint_clean`` fails on new
source violations.
"""
from .api import check, check_call, enforce
from .astlint import lint_paths, lint_source, self_lint
from .compiled import (
    COMPILED_PASSES,
    check_compiled,
    program_summary,
    summary_findings,
)
from .findings import AnalysisError, Finding, Report, Severity
from .passes import PASSES, register_pass

__all__ = [
    "check",
    "check_call",
    "check_compiled",
    "program_summary",
    "summary_findings",
    "enforce",
    "Finding",
    "Report",
    "Severity",
    "AnalysisError",
    "register_pass",
    "PASSES",
    "COMPILED_PASSES",
    "lint_source",
    "lint_paths",
    "self_lint",
]
