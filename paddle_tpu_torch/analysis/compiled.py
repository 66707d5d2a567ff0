"""Level-3 lint: passes over one program's summary.

Counterpart of ``paddle_tpu/analysis/compiled.py``. JAX reads what XLA
built (the optimized HLO and ``compiled.memory_analysis()``); the port's
program is the op record a capture would hold (``analysis.trace``), so
the summary is taken from it, and nothing runs:

    report = analysis.check_compiled(fn, *args)
    report.census    # {op: {"count", "bytes", "max_bytes"}}
    report.memory    # {"argument", "output", "temp", ..., "peak"}

Passes (each also usable over a stored summary, see
:func:`summary_findings`):

    collective-census  the ``c10d`` / ``_c10d_functional`` ops of the
                       trace under JAX's collective names
                       (``all-reduce``, ``all-gather``,
                       ``reduce-scatter``, ``collective-permute``,
                       ``all-to-all``) with their result bytes. Emits
                       ``unexpected-collective`` (ERROR) when a program
                       declared ``tp_numerics="exact"`` (or tp=1)
                       contains a reduction-order-bearing collective, and
                       ``resharding-copy`` (WARNING) for a gather/permute
                       moving >= ``reshard_bytes`` in one shot. Empty on
                       one card (the port has no tensor parallelism yet).
    memory-budget      the predicted per-device peak: the bytes of the
                       program's live tensors (``analysis.trace``: entry
                       tensors, i.e. weights, pool and inputs, from the
                       start; each tensor an op makes from that op until
                       its last reference; the pool written in place
                       counted once). Emits ``memory-budget`` (ERROR)
                       when a budget is declared and the peak exceeds it.

``mode`` follows :func:`analysis.check`: it controls how a CRASHING pass
(or a crashing trace) degrades: "collect" records a ``pass-crash``/
``compile-crash`` finding, "warn" warns, "error" raises. Rule findings
themselves are always collected; callers enforce. Every pass invocation
crosses the ``analysis.compiled`` fault site.
"""
from __future__ import annotations

import warnings

import torch

from .findings import AnalysisError, Finding, Report, Severity

__all__ = [
    "check_compiled", "program_summary", "summary_findings",
    "census_summary", "COMPILED_PASSES",
    "COLLECTIVE_OPS", "REDUCTION_OPS", "DEFAULT_RESHARD_BYTES",
]

#: collective kinds the census counts (JAX's HLO names).
COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all",
)
#: The subset whose result depends on a cross-device reduction ORDER —
#: the ops exact-mode numerics promise to avoid.
REDUCTION_OPS = frozenset({"all-reduce", "reduce-scatter"})

#: Single-shot transfer size at/above which a gather/permute is
#: reported as a probable full-tensor re-shard.
DEFAULT_RESHARD_BYTES = 8 << 20

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
# torch's collective ops by short name -> JAX's census name
_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _nbytes(shape, dtype):
    n = torch.empty((), dtype=dtype).element_size()
    for d in shape:
        n *= d
    return n


def trace_collectives(tr):
    """Per-occurrence collective list of one trace:
    ``[{"op", "bytes", "source"}]`` (source = ``file:line``)."""
    out = []
    for node in tr.nodes:
        if node.namespace not in _COLLECTIVE_NAMESPACES:
            continue
        op = _COLLECTIVES.get(node.op)
        if op is None:
            continue
        out.append({
            "op": op,
            "bytes": sum(_nbytes(s, d) for s, d in zip(node.out_shapes,
                                                       node.out_dtypes)),
            "source": f"{node.file}:{node.line}" if node.file else "",
        })
    return out


def census_summary(occurrences):
    """Aggregate per-occurrence collectives to the JSON-able census."""
    census = {}
    for occ in occurrences:
        entry = census.setdefault(
            occ["op"], {"count": 0, "bytes": 0, "max_bytes": 0}
        )
        entry["count"] += 1
        entry["bytes"] += occ["bytes"]
        entry["max_bytes"] = max(entry["max_bytes"], occ["bytes"])
    return census


def program_summary(tr):
    """The JSON-able L3 record of one traced program: its collective
    census and its per-device bytes (``TraceResult.memory``: argument,
    the entry tensors; output, new outputs plus the entry tensors
    written in place; alias, those written entry tensors; temp, the
    transient headroom above argument and new outputs; generated_code,
    0: a kernel's code is not memory a program allocates; ``peak`` =
    argument + output - alias + temp + generated_code)."""
    return {
        "census": census_summary(trace_collectives(tr)),
        "memory": dict(tr.memory),
    }


def _census_findings(ctx):
    census = ctx.summary.get("census") or {}
    findings = []
    exact_declared = ctx.tp_numerics == "exact" or (
        ctx.tp_numerics is None and ctx.tp_degree == 1
    )
    if exact_declared:
        for op in sorted(REDUCTION_OPS & set(census)):
            entry = census[op]
            declared = (
                f'tp_numerics="{ctx.tp_numerics}"'
                if ctx.tp_numerics is not None
                else f"tp_degree={ctx.tp_degree}"
            )
            findings.append(Finding(
                rule="unexpected-collective",
                severity=Severity.ERROR,
                message=(
                    f"{entry['count']} `{op}` op(s) "
                    f"({entry['bytes']} bytes total) in a program "
                    f"declared {declared}: reduction-order-bearing "
                    "collectives break the bit-exact numerics "
                    "contract — partial products were summed across "
                    "devices"
                ),
                op=op,
                root=ctx.program,
            ))
    for op in ("all-gather", "collective-permute"):
        entry = census.get(op)
        if entry and entry["max_bytes"] >= ctx.reshard_bytes:
            findings.append(Finding(
                rule="resharding-copy",
                severity=Severity.WARNING,
                message=(
                    f"`{op}` moving {entry['max_bytes']} bytes in one "
                    "shot — a full-tensor re-shard; constrain the "
                    "producer's sharding or raise `reshard_bytes` if "
                    "the transfer is intended"
                ),
                op=op,
                root=ctx.program,
            ))
    return findings


def _memory_findings(ctx):
    mem = ctx.summary.get("memory")
    budget = ctx.device_memory_budget
    if mem is None or budget is None:
        return []
    if mem["peak"] <= budget:
        return []
    parts = ", ".join(
        f"{k}={mem[k]}" for k in
        ("argument", "output", "temp", "generated_code", "alias")
    )
    return [Finding(
        rule="memory-budget",
        severity=Severity.ERROR,
        message=(
            f"program {ctx.program or '<compiled>'}: predicted "
            f"per-chip peak {mem['peak']} bytes exceeds "
            f"device_memory_budget={budget} ({parts}) — this config "
            "would run out of device memory at its first launch"
        ),
        root=ctx.program,
    )]


COMPILED_PASSES = {
    "collective-census": _census_findings,
    "memory-budget": _memory_findings,
}


class _Ctx:
    def __init__(self, summary, program, tp_numerics, tp_degree,
                 device_memory_budget, reshard_bytes):
        self.summary = summary
        self.program = program
        self.tp_numerics = tp_numerics
        self.tp_degree = tp_degree
        self.device_memory_budget = device_memory_budget
        self.reshard_bytes = reshard_bytes


def summary_findings(summary, *, program=None, tp_numerics=None,
                     tp_degree=None, device_memory_budget=None,
                     reshard_bytes=DEFAULT_RESHARD_BYTES,
                     mode="collect", passes=None):
    """Run the L3 rule set over a program summary. Pure host work; the
    crash/degradation contract and the ``analysis.compiled`` fault site
    are those of :func:`check_compiled`."""
    from ..resilience import faults

    findings = []
    for name, fn in COMPILED_PASSES.items():
        if passes is not None and name not in passes:
            continue
        ctx = _Ctx(summary, program, tp_numerics, tp_degree,
                   device_memory_budget, reshard_bytes)
        try:
            faults.fire("analysis.compiled", rule=name, program=program)
            findings.extend(fn(ctx))
        except Exception as e:
            # same isolation as the L1 passes: a crashing analyzer must
            # never take down the caller (an engine BUILD crosses this
            # in collect mode, so an L3 crash is never fatal there)
            if mode == "error":
                raise AnalysisError(
                    f"compiled-analysis pass {name!r} crashed: {e!r}"
                ) from e
            if mode == "warn":
                warnings.warn(
                    f"compiled-analysis pass {name!r} crashed and was "
                    f"skipped: {e!r}",
                    stacklevel=2,
                )
            else:
                findings.append(Finding(
                    rule="pass-crash",
                    severity=Severity.WARNING,
                    message=(
                        f"compiled-analysis pass {name!r} crashed: "
                        f"{e!r}"
                    ),
                    root=program,
                ))
    return findings


def check_compiled(target, *args, mode="collect", passes=None,
                   static_argnums=(), donate_argnums=(),
                   tp_numerics=None, tp_degree=None,
                   device_memory_budget=None, program=None,
                   reshard_bytes=DEFAULT_RESHARD_BYTES):
    """Trace ``target(*args)`` over fake tensors (or take a
    ``TraceResult`` already made) and run the L3 passes. Nothing runs on
    a device. Returns a :class:`Report` carrying ``report.census`` and
    ``report.memory`` beside the findings.

    ``tp_numerics``/``tp_degree`` declare the numerics contract the
    census judges against; ``device_memory_budget`` (bytes per device)
    arms the memory gate; ``program`` labels findings' ``root``."""
    from .trace import TraceResult, trace

    if mode not in ("collect", "warn", "error"):
        raise ValueError(
            f'mode must be "collect", "warn" or "error", got {mode!r}'
        )
    report = Report()
    report.census = {}
    report.memory = None
    try:
        if isinstance(target, TraceResult):
            tr = target
        else:
            from ..observability import jit_events

            with jit_events.suppress():
                tr = trace(target, args, {}, static_argnums=static_argnums)
        summary = program_summary(tr)
    except torch.AcceleratorError:
        raise
    except Exception as e:
        # a trace failure degrades exactly like an L1 trace failure
        if mode == "error":
            raise AnalysisError(
                f"analysis compile failed: {e!r}"
            ) from e
        if mode == "warn":
            warnings.warn(
                f"analysis compile failed and was skipped: {e!r}",
                stacklevel=2,
            )
        else:
            report.add(Finding(
                rule="compile-crash",
                severity=Severity.WARNING,
                message=f"analysis compile crashed: {e!r}",
                root=program,
            ))
        return report
    report.census = summary["census"]
    report.memory = summary["memory"]
    report.extend(summary_findings(
        summary, program=program, tp_numerics=tp_numerics,
        tp_degree=tp_degree, device_memory_budget=device_memory_budget,
        reshard_bytes=reshard_bytes, mode=mode, passes=passes,
    ))
    return report
