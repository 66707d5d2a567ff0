"""Pluggable analysis passes over a recorded program.

Counterpart of ``paddle_tpu/analysis/passes.py``: the same registry, the
same crash isolation and the same rule names, over the op record of
``analysis.trace`` instead of a closed jaxpr. Each pass is
``fn(ctx) -> iterable[Finding]`` registered under a stable rule id. The
runner isolates pass failures (an analyzer must never take down
serving): a crashing pass becomes a ``pass-crash`` finding by default, a
warning under ``mode="warn"``, and an ``AnalysisError`` only under
``mode="error"``. Every pass invocation is a fault-injection site
(``analysis.pass``).

Rule catalog, read for a program that is captured into a CUDA graph and
replayed:

    retrace-hazard   a capture hazard: a Python scalar argument, or a
                     Python scalar the function closes over, that
                     reaches an op is frozen into the graph and replayed
                     silently when it changes (worse than JAX's retrace,
                     which at least recompiles); Python control flow on
                     shapes (one capture per shape)
    dtype-drift      drift because of a float64 or a Python-typed input:
                     a 64-bit result in a program handed no 64-bit float
                     (an upcast, a float64 constant); integer tensors a
                     Python float promotes; a Python number handed in by
                     value (promotion follows the scalar)
    host-sync        ``.item()``, tensor truthiness, a copy to the CPU,
                     a data-dependent shape (``nonzero``, masked
                     select): a sync a capture cannot hold
    const-bloat      a tensor made from host data inside the traced
                     region (``torch.tensor``/``as_tensor``/
                     ``from_numpy``) at or above the size threshold
    donation-misuse  XLA's buffer donation has no counterpart: the port's
                     programs write the pool in place by design (the
                     trace counts those pages once). Registered under
                     its name; it finds nothing.
    dead-output      an op whose result reaches neither an output of the
                     program nor a write into one of its entry tensors
"""
from __future__ import annotations

import ast
import inspect
import os
import textwrap
from dataclasses import dataclass

import torch

from .findings import AnalysisError, Finding, Severity
from .trace import TraceResult, fn_location

__all__ = ["AnalysisContext", "PASSES", "register_pass", "run_passes"]


@dataclass
class AnalysisContext:
    trace: TraceResult
    const_bloat_bytes: int = 1 << 20

    @property
    def fn(self):
        return self.trace.fn


# --- registry ---------------------------------------------------------------
PASSES: dict = {}


def register_pass(name):
    """Register an analysis pass under ``name`` (decorator). Third-party
    passes plug in the same way the built-ins do."""

    def deco(fn):
        PASSES[name] = fn
        return fn

    return deco


# --- source helpers ---------------------------------------------------------
def _source_tree(fn):
    """(ast, first line offset) of ``fn``'s source, or (None, 0)."""
    raw = inspect.unwrap(getattr(fn, "__func__", fn))
    code = getattr(raw, "__code__", None)
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(raw)))
    except (OSError, TypeError, SyntaxError, IndentationError):
        return None, 0
    return tree, (code.co_firstlineno - 1) if code is not None else 0


def _value_lines(tree, base):
    """{name: lines where ``name`` is read as a value}: every load but
    those inside the test of an ``if``/``while``/``assert`` or a
    conditional expression (a Python branch picks code, it hands no
    value to an op)."""
    control = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.IfExp, ast.While, ast.Assert)):
            control.update(id(n) for n in ast.walk(node.test))
    lines: dict = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                and id(node) not in control):
            lines.setdefault(node.id, set()).add(base + node.lineno)
    return lines


def _reaches_op(ctx, name, value, lines):
    """True if an op recorded on a line of the analyzed function that
    reads ``name`` was handed ``value`` (same type, same value)."""
    prefer = ctx.trace.prefer_file
    where = lines.get(name, set())
    if not where or prefer is None:
        return False
    for node in ctx.trace.nodes:
        if (node.line in where and node.file is not None
                and os.path.abspath(node.file) == prefer
                and any(type(s) is type(value) and s == value
                        for s in node.scalars)):
            return True
    return False


# --- built-in passes --------------------------------------------------------
@register_pass("retrace-hazard")
def _retrace_hazard(ctx):
    """(a) Python scalars that reach an op from the closure or the
    arguments: frozen into the captured graph; a later change is not
    seen. (b) Python control flow on shapes: one capture per shape."""
    fn = ctx.fn
    raw = inspect.unwrap(getattr(fn, "__func__", fn))
    file, line = fn_location(fn)
    tree, base = _source_tree(fn)
    lines = _value_lines(tree, base) if tree is not None else {}
    code = getattr(raw, "__code__", None)
    if code is not None and code.co_freevars and raw.__closure__:
        for name, cell in zip(code.co_freevars, raw.__closure__):
            try:
                val = cell.cell_contents
            except ValueError:
                continue  # empty cell
            if (type(val) in (bool, int, float)
                    and _reaches_op(ctx, name, val, lines)):
                yield Finding(
                    rule="retrace-hazard",
                    severity=Severity.WARNING,
                    message=(
                        f"closure captures Python {type(val).__name__} "
                        f"'{name}' by value and hands it to an op: it is "
                        "frozen into the captured program as a constant "
                        "and later rebinds are NOT seen by its replays; "
                        "stage it into a device buffer instead"
                    ),
                    file=file,
                    line=line,
                )
    for name, val in ctx.trace.arg_scalars.items():
        if _reaches_op(ctx, name, val, lines):
            yield Finding(
                rule="retrace-hazard",
                severity=Severity.WARNING,
                message=(
                    f"argument '{name}' is a Python {type(val).__name__} "
                    "handed to an op: it is frozen into the captured "
                    "program and a replay with another value silently "
                    "keeps this one; pass it as a tensor"
                ),
                file=file,
                line=line,
            )
    if tree is None:
        return
    for node in ast.walk(tree):
        if not isinstance(node, (ast.If, ast.IfExp, ast.While)):
            continue
        # `if bad_shape: raise ...` is a validation guard, not a branch
        # that multiplies captures: skip raise-only bodies
        if isinstance(node, ast.If) and all(
            isinstance(stmt, ast.Raise) for stmt in node.body
        ):
            continue
        if _mentions_shape(node.test):
            yield Finding(
                rule="retrace-hazard",
                severity=Severity.WARNING,
                message=(
                    "shape-dependent Python control flow: every distinct "
                    "input shape captures a different program; pad to "
                    "buckets or branch in dataflow (torch.where)"
                ),
                file=file,
                line=base + node.test.lineno,
            )


def _mentions_shape(test):
    # Precision over recall, as in JAX: only explicit `.shape` access.
    # `.ndim` is exempt (rank dispatch), and so is bare `len(...)`
    # (statically indistinguishable from a Python-container length).
    for sub in ast.walk(test):
        if isinstance(sub, ast.Attribute) and sub.attr == "shape":
            return True
    return False


def _width(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _is_wide(dtype):
    """64 bits PER COMPONENT (complex64's halves are 32-bit)."""
    return (dtype.is_floating_point or dtype.is_complex) and _width(dtype) \
        >= (16 if dtype.is_complex else 8)


@register_pass("dtype-drift")
def _dtype_drift(ctx):
    """Dtypes that drift because of a float64 or a Python-typed input:
    (a) a Python number handed in by value (promotion follows the
    scalar, as JAX's weakly-typed inputs); (b) an op that widens to 64
    bits where the program was handed no 64-bit float (JAX's "widening
    conversion", an accidental ``.double()`` or a float64 constant); (c)
    an op whose integer tensors a Python float promotes to a float
    result. Deliberate f32 work in a 16-bit program (RoPE angles, the
    sampling noise) comes from an explicit dtype, not a drift."""
    tr = ctx.trace
    file, line = tr.fn_file, tr.fn_line
    tree, base = _source_tree(ctx.fn)
    lines = _value_lines(tree, base) if tree is not None else {}
    for name, val in tr.arg_scalars.items():
        if type(val) is bool or not _reaches_op(ctx, name, val, lines):
            continue
        yield Finding(
            rule="dtype-drift",
            severity=Severity.WARNING,
            message=(
                f"weakly-typed {type(val).__name__} input '{name}' (a "
                "Python scalar passed by value): promotion downstream "
                "follows the scalar, so dtypes can silently drift; pin "
                "the dtype (e.g. torch.tensor(x, dtype=...))"
            ),
            file=file,
            line=line,
        )
    handed_wide = any(_is_wide(d) for d in tr.entry_float_dtypes)
    for node in tr.nodes:
        wide = [d for d in node.out_dtypes if _is_wide(d)]
        if (wide and not handed_wide
                and not any(_is_wide(d) for d in node.in_dtypes)):
            yield Finding(
                rule="dtype-drift",
                severity=Severity.WARNING,
                message=(
                    f"widening to {str(wide[0]).replace('torch.', '')}: "
                    "64-bit compute in a program handed no 64-bit float "
                    "is usually an accidental upcast, and a captured "
                    "graph replays it on every step"
                ),
                file=node.file,
                line=node.line,
                op=node.op,
            )
        elif (node.in_dtypes and any(type(v) is float for v in node.scalars)
                and not any(d.is_floating_point or d.is_complex
                            for d in node.in_dtypes)
                and any(d.is_floating_point for d in node.out_dtypes)):
            yield Finding(
                rule="dtype-drift",
                severity=Severity.WARNING,
                message=(
                    "a Python float promotes integer tensors to a float "
                    "result: the dtype follows the scalar (the default "
                    "dtype); convert the tensor explicitly"
                ),
                file=node.file,
                line=node.line,
                op=node.op,
            )


@register_pass("host-sync")
def _host_sync(ctx):
    """Host round-trips: a value asked of the device (``.item()``,
    truthiness), a data-dependent shape, a copy to the CPU. One finding
    per source line and op; a CUDA graph capture cannot hold any."""
    tr = ctx.trace
    if tr.break_finding is not None:
        yield tr.break_finding
    seen = set()
    for node in tr.nodes:
        if node.kind != "sync":
            continue
        key = (node.file, node.line, node.op)
        if key in seen:
            continue
        seen.add(key)
        if node.op == "_local_scalar_dense":
            what = ("tensor value forced to the host (.item()/bool()/"
                    "float() on a tensor)")
        elif node.op in ("_to_copy", "copy_"):
            what = "copy to the CPU"
        else:
            what = f"data-dependent output shape ({node.op})"
        yield Finding(
            rule="host-sync",
            severity=Severity.ERROR,
            message=(
                f"{what}: the host waits for the device here, which a "
                "CUDA graph capture cannot record; keep the branch in "
                "dataflow (torch.where) or hoist it out of the captured "
                "region"
            ),
            file=node.file,
            line=node.line,
            op=node.op,
        )


@register_pass("const-bloat")
def _const_bloat(ctx):
    """Tensors made from host data inside the traced region: copied in
    at every capture and held by the program."""
    for node in ctx.trace.nodes:
        if node.kind != "const" or not node.out_shapes:
            continue
        shape, dtype = node.out_shapes[0], node.out_dtypes[0]
        nbytes = _width(dtype)
        for n in shape:
            nbytes *= n
        if nbytes >= ctx.const_bloat_bytes:
            yield Finding(
                rule="const-bloat",
                severity=Severity.WARNING,
                message=(
                    f"{nbytes / 1e6:.1f} MB array "
                    f"({str(dtype).replace('torch.', '')}{list(shape)}) "
                    "made from host data inside the program; pass it as "
                    "an argument so it lives in one device buffer"
                ),
                file=node.file,
                line=node.line,
                op=node.op,
            )


@register_pass("donation-misuse")
def _donation_misuse(ctx):
    """XLA's donation (a buffer handed to the program to reuse) has no
    counterpart in the port: its programs update the pool in place by
    design. Nothing to find."""
    return ()


@register_pass("dead-output")
def _dead_output(ctx):
    """Ops whose results reach neither an output of the program, nor a
    live op, nor a write into an entry tensor: computed, thrown away."""
    tr = ctx.trace
    live = set(tr.outputs)
    # storages read later (or returned): a write through a view of one
    # is live
    live_keys = set(tr.output_keys)
    dead = []
    for node in reversed(tr.nodes):
        keep = (node.effect or any(u in live for u in node.outputs)
                or any(k in live_keys for k in node.write_keys))
        if keep:
            live.update(node.inputs)
            live_keys.update(node.in_keys)
        elif node.outputs:
            dead.append(node)
    for node in reversed(dead):
        yield Finding(
            rule="dead-output",
            severity=Severity.INFO,
            message=(
                f"result of '{node.op}' is never used (dead computation "
                "in the traced program)"
            ),
            file=node.file,
            line=node.line,
            op=node.op,
        )


def run_passes(ctx, mode="collect", passes=None):
    """Run the (selected) passes over ``ctx``, isolating crashes.

    mode="collect": a crashing pass becomes a ``pass-crash`` finding.
    mode="warn":    it degrades to a ``warnings.warn``.
    mode="error":   the failure surfaces as ``AnalysisError``.
    """
    from ..resilience import faults

    findings = []
    if passes is None:
        selected = PASSES
    else:
        unknown = [name for name in passes if name not in PASSES]
        if unknown:
            raise ValueError(
                f"unknown analysis pass(es) {unknown}; registered: "
                f"{sorted(PASSES)}"
            )
        selected = {name: PASSES[name] for name in passes}
    for name, pass_fn in selected.items():
        try:
            faults.fire("analysis.pass", rule=name)
            findings.extend(pass_fn(ctx) or ())
        except Exception as e:
            if mode == "error":
                raise AnalysisError(
                    f"analysis pass '{name}' failed: {e!r}"
                ) from e
            if mode == "warn":
                import warnings

                warnings.warn(
                    f"analysis pass '{name}' failed and was skipped: "
                    f"{e!r}",
                    stacklevel=2,
                )
            else:
                findings.append(Finding(
                    rule="pass-crash",
                    severity=Severity.WARNING,
                    message=f"analysis pass '{name}' crashed: {e!r}",
                ))
    findings.sort(key=lambda f: -int(f.severity))
    return findings
