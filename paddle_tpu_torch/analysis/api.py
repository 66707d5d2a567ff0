"""``analysis.check`` — trace a function and run the analysis passes.

Counterpart of ``paddle_tpu/analysis/api.py``::

    report = analysis.check(fn, *example_args)
    for f in report:
        print(f.render())

``fn`` is a function of tensors (a serving program, a layer's forward).
Nothing executes: the function runs over fake tensors
(``analysis.trace``) and the passes inspect the op record.

``mode`` controls how a CRASHING PASS (or a crashing trace) is handled:
"collect" (default) records a ``pass-crash``/``trace-crash`` finding,
"warn" degrades to ``warnings.warn``, "error" raises ``AnalysisError``.
A device error (``torch.AcceleratorError``) is never contained: the
trace runs nothing on the device, so one means the process's CUDA
context is broken. ``enforce`` maps a finished report onto the same
modes for the ``check=`` choke points.
"""
from __future__ import annotations

import warnings

import torch

from .findings import AnalysisError, Finding, Report, Severity
from .passes import AnalysisContext, run_passes
from .trace import trace

__all__ = ["check", "check_call", "enforce", "traced"]


def traced(fn, args=(), kwargs=None, *, mode="collect", root=None,
           static_argnums=(), fake=None):
    """``(TraceResult or None, Report)``: the trace of ``fn`` and a
    report holding the ``trace-crash`` finding when it crashed (raised
    under ``mode="error"``, warned under "warn"). Shared by ``check``
    and ``check_compiled``, so one trace serves both levels. ``fake``:
    the ``FakeTensorMode`` of fakes ``fn`` closes over (``trace``)."""
    if mode not in ("collect", "warn", "error"):
        raise ValueError(
            f'mode must be "collect", "warn" or "error", got {mode!r}'
        )
    report = Report()
    try:
        # trace-only work must not read as capture activity: mask the
        # compile log for the analysis trace
        from ..observability import jit_events

        with jit_events.suppress():
            return trace(fn, args, dict(kwargs or {}),
                         static_argnums=static_argnums, fake=fake), report
    except torch.AcceleratorError:
        raise
    except Exception as e:
        # same degradation contract as a crashing pass: an analyzer
        # failure must never take down the caller except under "error"
        if mode == "error":
            raise AnalysisError(f"analysis trace failed: {e!r}") from e
        if mode == "warn":
            warnings.warn(
                f"analysis trace failed and was skipped: {e!r}",
                stacklevel=3,
            )
        else:
            report.add(Finding(
                rule="trace-crash",
                severity=Severity.WARNING,
                message=f"analysis trace crashed: {e!r}",
                root=root,
            ))
        return None, report


def check_call(fn, args=(), kwargs=None, *, mode="collect", passes=None,
               static_argnums=(), donate_argnums=(),
               const_bloat_bytes=1 << 20, root=None, trace_result=None):
    """Option-safe form of :func:`check`: the call's args/kwargs are
    passed EXPLICITLY, so a user function whose own kwargs are named
    ``mode``/``passes``/... cannot collide with analyzer options.

    ``root``: entry-point label stamped on every finding
    (``Finding.root``): serving programs pass e.g. ``"serving.decode"``
    so a finding's ``file:line`` and the program that reaches it both
    render. ``trace_result``: a trace already made (``traced``) to run
    the passes over instead of tracing again."""
    if passes is not None:
        from .passes import PASSES

        unknown = [name for name in passes if name not in PASSES]
        if unknown:
            raise ValueError(
                f"unknown analysis pass(es) {unknown}; registered: "
                f"{sorted(PASSES)}"
            )
    tr = trace_result
    if tr is None:
        tr, report = traced(fn, args, kwargs, mode=mode, root=root,
                            static_argnums=static_argnums)
        if tr is None:
            return report
    elif mode not in ("collect", "warn", "error"):
        raise ValueError(
            f'mode must be "collect", "warn" or "error", got {mode!r}'
        )
    report = Report()
    ctx = AnalysisContext(trace=tr, const_bloat_bytes=const_bloat_bytes)
    report.extend(run_passes(ctx, mode=mode, passes=passes))
    if root is not None:
        for f in report.findings:
            if f.root is None:
                f.root = root
    return report


def check(fn, *args, mode="collect", passes=None, static_argnums=(),
          donate_argnums=(), const_bloat_bytes=1 << 20, root=None,
          **kwargs):
    """Trace ``fn(*args, **kwargs)`` (no execution) and run the analysis
    passes; returns a ``Report`` of structured findings.

    static_argnums: positional arguments handed over as they are (not
    made fake). donate_argnums: accepted for JAX's signature (the
    ``donation-misuse`` rule has no torch counterpart).
    const_bloat_bytes: threshold for the const-bloat rule. passes:
    optional iterable of rule names to restrict the run. If the analyzed
    function takes kwargs named like these options, use
    :func:`check_call` instead.
    """
    return check_call(
        fn, args, kwargs, mode=mode, passes=passes,
        static_argnums=static_argnums, donate_argnums=donate_argnums,
        const_bloat_bytes=const_bloat_bytes, root=root,
    )


def enforce(report, mode, what="analysis"):
    """Apply a ``check="warn"|"error"`` policy to a finished report:
    ERROR findings raise under "error" and warn under "warn"; WARNING
    findings warn under both. Returns the report for chaining."""
    if mode not in ("warn", "error"):
        raise ValueError(f'check mode must be "warn" or "error", got {mode!r}')
    errors = report.errors
    if errors and mode == "error":
        raise AnalysisError(
            f"{what}: {len(errors)} blocking finding(s):\n"
            + "\n".join(f.render() for f in errors),
            report,
        )
    worth_warning = report.at_least(Severity.WARNING)
    if worth_warning:
        warnings.warn(
            f"{what}: {len(worth_warning)} finding(s):\n"
            + "\n".join(f.render() for f in worth_warning),
            stacklevel=3,
        )
    return report
