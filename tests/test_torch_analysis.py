"""The port's static analyzer (``paddle_tpu_torch.analysis``) on the CPU.

* L2 parity: every source snippet of ``tests/test_analysis.py``'s
  ``TestAstLint``, ``TestConcurrencyRules`` and ``TestCliExitCodes``
  goes through the JAX linter and the port's, and the ``(rule, line)``
  sets are equal. The port's torch sync points and its traced roots (the
  adapter's entry points, the functions a ``Program`` captures) on
  snippets of their own.
* L1 and L3 to the contracts JAX's tests pin: the functions of
  ``TestJaxprRules``, ``TestSummaryRules``, ``TestCheckCompiled``,
  ``TestAnalysisPassFaultSite`` and ``TestCompiledFaultSite`` written in
  torch give the same rules, firing or quiet (JAX's own L1 passes need
  ``jax.core.ClosedJaxpr``, which the installed jax lacks, so the port is
  held to what those tests assert, not to their run); the serving gates
  of ``TestServingDecodeCheck``, ``TestEngineProgramFamily`` and
  ``TestEngineMemoryBudgetGate`` on the port's engine.
* Isolation: each hand-kernel wrapper's fake-tensor branch returns the
  kernel's shapes and dtypes, runs no plain version and counts nothing;
  ``check_programs`` moves no launch count, capture counter or
  capture-log event and leaves the programs' outputs as they were.
* The self-lint gate and the CLI's exit codes.

Every engine here is built by the test that reads it (no state is shared
between tests).
"""
import inspect
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu import analysis as jax_analysis
from paddle_tpu_torch import analysis, serving
from paddle_tpu_torch.analysis import AnalysisError, Finding, Severity
from paddle_tpu_torch.analysis.compiled import summary_findings
from paddle_tpu_torch.analysis.trace import trace
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import jit_events
from paddle_tpu_torch.resilience import faults

from test_analysis import _AST_BAD, _AST_CONC

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _line_of(fn, snippet):
    lines, start = inspect.getsourcelines(fn)
    for i, ln in enumerate(lines):
        if snippet in ln:
            return start + i
    raise AssertionError(f"{snippet!r} not found in {fn}")


def _same_file(path):
    return path is not None and os.path.samefile(path, __file__)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


# ------------------------------------------------------------ level 2 --
# the sources of TestCliExitCodes (inline there)
_CLI_CLEAN = "def fine(x):\n    return x + 1\n"
_CLI_MESSY = (
    "def messy():\n"
    "    try:\n"
    "        return 1\n"
    "    except Exception:\n"
    "        pass\n"
)
_CLI_TORN = "def broken(:\n"


@pytest.mark.parametrize("src", [_AST_BAD, _AST_CONC, _CLI_CLEAN,
                                 _CLI_MESSY, _CLI_TORN],
                         ids=["ast_bad", "ast_conc", "cli_clean",
                              "cli_messy", "cli_torn"])
def test_lint_parity_with_jax(src):
    ours = analysis.lint_source(src, filename="snippet.py")
    theirs = jax_analysis.lint_source(src, filename="snippet.py")
    assert {(f.rule, f.line) for f in ours} == {
        (f.rule, f.line) for f in theirs}
    assert [f.severity.name for f in ours] == [
        f.severity.name for f in theirs]


def test_finding_and_report_render_as_jax():
    kw = dict(rule="host-sync", message="m", file="a.py", line=3,
              op="mul", root="serving.decode")
    ours = Finding(severity=Severity.ERROR, **kw)
    theirs = jax_analysis.Finding(severity=jax_analysis.Severity.ERROR,
                                  **kw)
    assert ours.render() == theirs.render()
    assert analysis.Report([ours]).render() == \
        jax_analysis.Report([theirs]).render()
    assert analysis.Report().render() == jax_analysis.Report().render()


_TORCH_SYNCS = """\
import torch


class LlamaServingAdapter:
    def decode(self, x):
        n = x.sum().item()
        y = self._helper(x)
        if (x > 0).any():
            y = y + 1
        return y.cpu()

    def _helper(self, x):
        return float(x.max()) * x

    def untraced(self, x):
        return x.tolist()
"""

_CAPTURED = """\
class Engine:
    def _decode_program(self):
        return self._program(self._decode_fn(1), None)

    def _decode_fn(self, f):
        def decode_fn():
            return f.numpy()
        return decode_fn

    def _prefill_program(self):
        def prefill_fn():
            torch.cuda.synchronize()
        return Program(prefill_fn, None)

    def _other(self, x):
        return x.item()
"""


def _src_line(src, snippet):
    for i, ln in enumerate(src.splitlines()):
        if snippet in ln:
            return i + 1
    raise AssertionError(snippet)


def test_torch_sync_points_in_the_adapter_roots():
    """The adapter's entry points are traced roots by path: torch's sync
    points there and in the methods they reach are flagged; an
    unreachable method and the same source under another path are not."""
    fs = analysis.lint_source(_TORCH_SYNCS, filename="adapter.py",
                              relpath=os.path.join("serving", "adapter.py"))
    lines = {f.line for f in fs if f.rule == "host-sync-in-traced"}
    assert lines == {
        _src_line(_TORCH_SYNCS, ".item()"),
        _src_line(_TORCH_SYNCS, "(x > 0).any()"),
        _src_line(_TORCH_SYNCS, "y.cpu()"),
        _src_line(_TORCH_SYNCS, "float(x.max())"),
    }
    assert not analysis.lint_source(_TORCH_SYNCS, filename="adapter.py",
                                    relpath="other.py")


def test_program_captured_functions_are_roots():
    """A function handed to ``Program``/``_program`` (or built by the
    call handed there) is a traced root."""
    fs = analysis.lint_source(_CAPTURED, filename="engine.py")
    assert {f.line for f in fs if f.rule == "host-sync-in-traced"} == {
        _src_line(_CAPTURED, "f.numpy()"),
        _src_line(_CAPTURED, "torch.cuda.synchronize()"),
    }


def test_engine_program_builders_are_lint_roots():
    """The real engine: every program builder is reached from a
    ``_program`` call (a sync planted in one would be flagged)."""
    from paddle_tpu_torch.analysis import astlint

    path = os.path.join(REPO_ROOT, "paddle_tpu_torch", "serving",
                        "engine.py")
    import ast

    mod = astlint._Module(ast.parse(open(path).read()))
    roots = astlint._roots(mod, os.path.join("serving", "engine.py"))
    assert {"Engine._decode_fn", "Engine._prefill_fn",
            "Engine._prefill_ext_fn", "Engine._cow_fn",
            "Engine._verify_fn"} <= roots


class TestSelfLint:
    def test_self_lint_clean(self):
        findings = analysis.self_lint()
        assert not findings, "\n".join(f.render() for f in findings)

    def test_cli_self_exits_zero_in_process(self, capsys):
        from paddle_tpu_torch.analysis.__main__ import main

        assert main(["--self"]) == 0
        assert "clean (0 findings)" in capsys.readouterr().out

    @pytest.mark.slow  # subprocess re-import of the package
    def test_cli_self_exits_zero(self):
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.analysis", "--self"],
            capture_output=True, text=True, cwd=REPO_ROOT, timeout=120,
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "clean" in r.stdout


class TestCliExitCodes:
    """``python -m paddle_tpu_torch.analysis``: 0 clean / 1 findings /
    2 usage, as JAX's."""

    def _main(self, argv):
        from paddle_tpu_torch.analysis.__main__ import main

        return main(argv)

    def test_clean_file_exits_zero_and_says_so(self, tmp_path, capsys):
        p = tmp_path / "ok.py"
        p.write_text(_CLI_CLEAN)
        assert self._main([str(p)]) == 0
        assert "clean (0 findings)" in capsys.readouterr().out

    def test_findings_exit_one(self, tmp_path, capsys):
        p = tmp_path / "bad.py"
        p.write_text(_CLI_MESSY)
        assert self._main([str(p)]) == 1
        assert "broad-except" in capsys.readouterr().out

    def test_unreadable_source_is_findings_not_usage(self, tmp_path,
                                                     capsys):
        p = tmp_path / "torn.py"
        p.write_text(_CLI_TORN)
        assert self._main([str(p)]) == 1
        assert "parse-error" in capsys.readouterr().out

    def test_no_arguments_is_usage_error(self):
        with pytest.raises(SystemExit) as ei:
            self._main([])
        assert ei.value.code == 2


# ------------------------------------------------------------ level 1 --
class TestProgramRules:
    """``TestJaxprRules``' functions, written in torch."""

    def test_host_sync_trace_break(self):
        def bad(t):
            if float((t * 2).sum()) > 0:
                return t
            return -t

        fs = analysis.check(bad, _t([1.0, 2.0])).by_rule("host-sync")
        assert len(fs) == 1
        assert fs[0].severity == Severity.ERROR
        assert _same_file(fs[0].file)
        assert fs[0].line == _line_of(bad, "if float")

    def test_host_sync_in_a_loop_once_per_line(self):
        # JAX's callback-in-a-loop case: a Python loop unrolls into the
        # captured program, so every iteration syncs; one finding a line
        def bad(t):
            acc = t
            for i in range(3):
                acc = acc + (t * i).sum().item()
            return acc

        fs = analysis.check(bad, _t([1.0])).by_rule("host-sync")
        assert len(fs) == 1 and fs[0].op == "_local_scalar_dense"
        assert fs[0].line == _line_of(bad, ".item()")

    def test_host_sync_data_dependent_shape_and_numpy(self):
        def nz(t):
            return torch.nonzero(t).sum()

        def to_np(t):
            return t.numpy()

        (f,) = analysis.check(nz, _t([1.0, 0.0])).by_rule("host-sync")
        assert f.op == "nonzero" and f.line == _line_of(nz, "nonzero")
        (f,) = analysis.check(to_np, _t([1.0])).by_rule("host-sync")
        assert f.line == _line_of(to_np, "t.numpy()")

    def test_retrace_hazard_closure_scalar(self):
        scale = 3

        def bad(t):
            return t * scale

        fs = analysis.check(bad, _t([1.0])).by_rule("retrace-hazard")
        assert len(fs) == 1
        assert "'scale'" in fs[0].message
        assert _same_file(fs[0].file)
        assert fs[0].line == _line_of(bad, "def bad")

    def test_closure_flag_that_only_picks_code_is_no_hazard(self):
        # the serving decode program's any_sample: a Python branch picks
        # the program, it hands no value to an op
        sample = True

        def fine(t):
            return t * 2.0 if sample else t

        assert not analysis.check(fine, _t([1.0])).by_rule(
            "retrace-hazard")

    def test_retrace_hazard_shape_branch(self):
        def bad(t):
            if t.shape[0] > 2:
                return t * 2.0
            return t + 0.0

        fs = analysis.check(bad, _t([1.0])).by_rule("retrace-hazard")
        assert len(fs) == 1
        assert "shape-dependent" in fs[0].message
        assert fs[0].line == _line_of(bad, "if t.shape")

    def test_dtype_drift_weak_scalar_input(self):
        def bad(x, s):
            return x + s

        r = analysis.check(bad, torch.ones(3), 2.0)  # s passed by value
        fs = r.by_rule("dtype-drift")
        assert len(fs) == 1
        assert "weakly-typed" in fs[0].message
        assert fs[0].line == _line_of(bad, "def bad")
        # and it is frozen into the capture
        assert r.by_rule("retrace-hazard")

    def test_dtype_drift_float64_upcast(self):
        def bad(x):
            return x.double() * 2

        (f,) = analysis.check(bad, torch.ones(3)).by_rule("dtype-drift")
        assert f.op == "_to_copy" and "float64" in f.message
        assert f.line == _line_of(bad, "x.double()")

    def test_dtype_drift_python_float_promotes_integers(self):
        def bad(t, n):
            return t + n * 0.5

        r = analysis.check(bad, torch.ones(4), torch.arange(4))
        (f,) = r.by_rule("dtype-drift")
        assert f.op == "mul" and f.line == _line_of(bad, "n * 0.5")

    def test_deliberate_f32_in_a_16bit_program_is_no_drift(self):
        # RoPE angles and the sampling noise: f32 by an explicit dtype
        def fine(x, pos):
            angle = pos.to(torch.float32)[:, None] * torch.ones(4)
            u = torch.rand(x.shape, dtype=torch.float32)
            return x * angle.to(x.dtype), u

        r = analysis.check(fine, torch.ones(3, 4, dtype=torch.bfloat16),
                           torch.arange(3, dtype=torch.int32))
        assert not r.by_rule("dtype-drift"), r.render()

    def test_const_bloat(self):
        big = np.ones((512, 600), np.float32)  # ~1.2 MB

        def bad(x):
            return x + torch.as_tensor(big).sum()

        fs = analysis.check(bad, torch.ones(3)).by_rule("const-bloat")
        assert len(fs) == 1
        assert "MB array" in fs[0].message
        assert _same_file(fs[0].file)

    def test_donation_misuse_registered_and_quiet(self):
        def bad(a, b):
            return a + b

        x = torch.ones(4)
        r = analysis.check(bad, x, x, donate_argnums=(0,))
        assert "donation-misuse" in analysis.PASSES
        assert not r.by_rule("donation-misuse")

    def test_dead_output(self):
        def bad(t):
            y = t * 2.0  # noqa: F841
            return t + 1.0

        fs = analysis.check(bad, _t([1.0])).by_rule("dead-output")
        assert len(fs) == 1
        assert fs[0].op == "mul"
        assert fs[0].line == _line_of(bad, "y = t * 2.0")

    def test_write_through_a_view_is_live(self):
        def fine(x):
            y = torch.zeros(4)
            y[1:3] = x[:2]
            return y

        assert not analysis.check(fine, torch.ones(4)).by_rule(
            "dead-output")

    def test_known_clean_function_zero_findings(self):
        def clean(t):
            return t * 2.0 + 1.0

        r = analysis.check(clean, _t([1.0, 2.0]))
        assert len(r) == 0, r.render()

    def test_np_scalar_arg_stays_static_no_false_host_sync(self):
        def fine(t, thresh):
            if thresh > 0.5:
                return t * 2.0
            return t

        r = analysis.check(fine, _t([1.0]), np.float32(0.9))
        assert not r.by_rule("host-sync"), r.render()

    def test_trace_crash_isolated_per_mode(self):
        def broken(t):
            raise TypeError("not tracer-related")

        assert analysis.check(broken, _t([1.0])).by_rule("trace-crash")
        with pytest.warns(UserWarning, match="analysis trace failed"):
            analysis.check(broken, _t([1.0]), mode="warn")
        with pytest.raises(AnalysisError, match="analysis trace failed"):
            analysis.check(broken, _t([1.0]), mode="error")

    def test_device_error_is_never_contained(self):
        def broken(t):
            raise torch.AcceleratorError("sticky CUDA error")

        with pytest.raises(torch.AcceleratorError):
            analysis.check(broken, _t([1.0]))

    def test_len_branch_on_python_container_not_flagged(self):
        def fine(t, ks=(1, 2, 3)):
            if len(ks) > 1:
                return t * 2.0
            return t

        assert not analysis.check(fine, _t([1.0])).by_rule(
            "retrace-hazard")

    def test_invalid_mode_rejected(self):
        with pytest.raises(ValueError, match="mode must be"):
            analysis.check(lambda x: x, torch.ones(2), mode="eror")

    def test_unknown_pass_name_rejected(self):
        with pytest.raises(ValueError, match="unknown analysis pass"):
            analysis.check(lambda x: x, torch.ones(2), passes=["typo"])

    def test_register_pass_pluggable(self):
        @analysis.register_pass("test-rule")
        def _p(ctx):
            yield Finding(rule="test-rule", severity=Severity.INFO,
                          message="hi")

        try:
            r = analysis.check(lambda x: x + 1.0, torch.ones(2))
            assert r.by_rule("test-rule")
        finally:
            analysis.PASSES.pop("test-rule", None)

    def test_analysis_never_touches_the_real_tensors(self):
        x = torch.ones(3)
        seen = []

        def fn(t):
            seen.append(type(t).__name__)
            t.add_(5.0)
            return t * 2

        analysis.check(fn, x)
        analysis.check_compiled(fn, x)
        assert seen == ["FakeTensor", "FakeTensor"]
        torch.testing.assert_close(x, torch.ones(3))


# ------------------------------------------------------------ level 3 --
def _summary(census=None, memory=None):
    return {"census": census or {}, "memory": memory}


class TestSummaryRules:
    """The rule logic over synthetic summaries, as JAX's."""

    _AR = {"all-reduce": {"count": 2, "bytes": 4096, "max_bytes": 2048}}

    def test_unexpected_collective_under_exact(self):
        fs = summary_findings(
            _summary(census=dict(self._AR)), program="serving.decode",
            tp_numerics="exact", tp_degree=2,
        )
        (f,) = [x for x in fs if x.rule == "unexpected-collective"]
        assert f.severity == Severity.ERROR
        assert 'tp_numerics="exact"' in f.message
        assert f.root == "serving.decode"

    def test_unexpected_collective_under_tp1_default(self):
        fs = summary_findings(_summary(census=dict(self._AR)),
                              tp_numerics=None, tp_degree=1)
        assert [x.rule for x in fs] == ["unexpected-collective"]
        assert "tp_degree=1" in fs[0].message

    def test_gathers_are_exact_safe(self):
        fs = summary_findings(
            _summary(census={"all-gather": {
                "count": 4, "bytes": 1 << 16, "max_bytes": 1 << 14}}),
            tp_numerics="exact", tp_degree=2,
        )
        assert not [x for x in fs if x.rule == "unexpected-collective"]

    def test_fast_mode_accepts_reductions(self):
        fs = summary_findings(_summary(census=dict(self._AR)),
                              tp_numerics="fast", tp_degree=2)
        assert not [x for x in fs if x.rule == "unexpected-collective"]

    def test_resharding_copy_threshold(self):
        big = {"all-gather": {
            "count": 1, "bytes": 9 << 20, "max_bytes": 9 << 20}}
        fs = summary_findings(_summary(census=big), tp_numerics="fast",
                              tp_degree=2)
        (f,) = [x for x in fs if x.rule == "resharding-copy"]
        assert f.severity == Severity.WARNING
        small = {"all-gather": {
            "count": 1, "bytes": 1024, "max_bytes": (8 << 20) - 1}}
        assert not summary_findings(_summary(census=small),
                                    tp_numerics="fast", tp_degree=2)

    def test_memory_budget_names_program_and_budget(self):
        mem = {"argument": 900, "output": 300, "temp": 100,
               "alias": 200, "generated_code": 0, "peak": 1100}
        (f,) = summary_findings(_summary(memory=mem),
                                program="serving.prefill[32]",
                                device_memory_budget=1000)
        assert f.rule == "memory-budget"
        assert f.severity == Severity.ERROR
        assert "serving.prefill[32]" in f.message
        assert "device_memory_budget=1000" in f.message
        assert "1100" in f.message
        assert f.root == "serving.prefill[32]"

    def test_memory_budget_quiet_under_budget_or_unarmed(self):
        mem = {"argument": 900, "output": 300, "temp": 100,
               "alias": 200, "generated_code": 0, "peak": 1100}
        assert not summary_findings(_summary(memory=mem),
                                    device_memory_budget=1100)
        assert not summary_findings(_summary(memory=mem))
        assert not summary_findings(_summary(memory=None),
                                    device_memory_budget=1)

    def test_passes_filter(self):
        fs = summary_findings(
            _summary(census=dict(self._AR),
                     memory={"argument": 2, "output": 0, "temp": 0,
                             "alias": 0, "generated_code": 0, "peak": 2}),
            tp_numerics="exact", tp_degree=2, device_memory_budget=1,
            passes=("memory-budget",),
        )
        assert [x.rule for x in fs] == ["memory-budget"]


class TestCheckCompiled:
    def test_clean_program_census_and_memory(self):
        r = analysis.check_compiled(lambda x: x * 2.0 + 1.0,
                                    torch.ones(16, 16))
        assert r.census == {}          # one device: no collectives
        mem = r.memory
        # 1 KiB in; the product (freed after the sum) and the output
        assert (mem["argument"], mem["output"], mem["peak"]) == (
            1024, 1024, 3072)
        assert mem["peak"] == (mem["argument"] + mem["output"]
                               - mem["alias"] + mem["temp"])
        assert len(r) == 0, r.render()

    def test_accepts_a_trace(self):
        tr = trace(lambda x: x + 1.0, (torch.ones(4),), {})
        assert analysis.check_compiled(tr).memory["argument"] == 16

    def test_in_place_write_counted_once(self):
        pool = torch.zeros(64, 64)

        def write(x):
            pool[:4].copy_(x)
            return x.sum()

        mem = analysis.check_compiled(write, torch.ones(4, 64)).memory
        assert mem["alias"] == pool.numel() * 4
        assert mem["argument"] == (64 + 4) * 64 * 4
        assert mem["peak"] == mem["argument"] + 512  # the 4-byte sum

    def test_memory_budget_finding_on_real_program(self):
        r = analysis.check_compiled(lambda x: x @ x, torch.ones(64, 64),
                                    device_memory_budget=1, program="toy")
        (f,) = r.by_rule("memory-budget")
        assert "toy" in f.message
        assert "device_memory_budget=1" in f.message

    def test_compile_crash_isolated_per_mode(self):
        def broken(x):
            raise TypeError("not traceable")

        assert analysis.check_compiled(broken, torch.ones(2)).by_rule(
            "compile-crash")
        with pytest.warns(UserWarning, match="analysis compile"):
            analysis.check_compiled(broken, torch.ones(2), mode="warn")
        with pytest.raises(AnalysisError, match="analysis compile"):
            analysis.check_compiled(broken, torch.ones(2), mode="error")

    def test_invalid_mode_rejected(self):
        with pytest.raises(ValueError, match="mode must be"):
            analysis.check_compiled(lambda x: x, torch.ones(2), mode="eror")


class TestAnalysisPassFaultSite:
    def _target(self):
        def fn(t):
            return t * 2.0

        return fn

    def test_check_warn_degrades_pass_crash_to_warning(self):
        spec = faults.FaultSpec(RuntimeError("pass exploded"), at=1)
        with faults.inject({"analysis.pass": spec}) as inj:
            with pytest.warns(UserWarning, match="pass exploded"):
                r = analysis.check(self._target(), _t([1.0]), mode="warn")
        assert inj.fired["analysis.pass"] == 1
        assert isinstance(r, analysis.Report)

    def test_check_error_surfaces_pass_crash(self):
        spec = faults.FaultSpec(RuntimeError("pass exploded"), at=1)
        with faults.inject({"analysis.pass": spec}):
            with pytest.raises(AnalysisError, match="pass exploded"):
                analysis.check(self._target(), _t([1.0]), mode="error")

    def test_default_collect_records_pass_crash_finding(self):
        spec = faults.FaultSpec(RuntimeError("boom"), at=1)
        with faults.inject({"analysis.pass": spec}):
            r = analysis.check(self._target(), _t([1.0]))
        assert r.by_rule("pass-crash")

    def test_pass_raising_analysis_error_is_still_isolated(self):
        spec = faults.FaultSpec(AnalysisError("rogue pass"), at=1)
        with faults.inject({"analysis.pass": spec}):
            r = analysis.check(self._target(), _t([1.0]))
        assert r.by_rule("pass-crash")


class TestCompiledFaultSite:
    def test_collect_records_pass_crash(self):
        spec = faults.FaultSpec(RuntimeError("L3 boom"), at=1)
        with faults.inject({"analysis.compiled": spec}) as inj:
            fs = summary_findings(_summary(), program="serving.decode",
                                  device_memory_budget=1)
        assert inj.fired["analysis.compiled"] == 1
        (f,) = [x for x in fs if x.rule == "pass-crash"]
        assert f.severity == Severity.WARNING
        assert f.root == "serving.decode"

    def test_warn_and_error_modes(self):
        spec = faults.FaultSpec(RuntimeError("L3 boom"), every=1)
        with faults.inject({"analysis.compiled": spec}):
            with pytest.warns(UserWarning, match="L3 boom"):
                summary_findings(_summary(), mode="warn")
            with pytest.raises(AnalysisError, match="L3 boom"):
                summary_findings(_summary(), mode="error")

    def test_engine_build_survives_l3_crash(self):
        spec = faults.FaultSpec(RuntimeError("L3 boom"), every=1)
        with faults.inject({"analysis.compiled": spec}):
            with pytest.warns(UserWarning, match="pass-crash"):
                eng = serving.Engine(_model(), serving.EngineConfig(
                    max_batch_slots=2, max_model_len=32, page_size=8,
                    device_memory_budget=1 << 30,
                ))
        assert eng.pool is not None  # degraded to a warning, built


# ------------------------------------------------------- kernel branches --
def _kernel_nodes(fn, *args):
    """Trace ``fn(*args)``; -> (kernel nodes, outputs' (shape, dtype))."""
    tr = trace(fn, args, {})
    out = fn(*args)   # the plain version on the real CPU tensors
    outs = out if isinstance(out, tuple) else (out,)
    ours = [n for n in tr.nodes if n.kind == "kernel"]
    return ours, [(tuple(o.shape), o.dtype) for o in outs]


def _pages(quant=False, hkv=2, pages=6, ps=8, d=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    if quant:
        return (torch.randint(-127, 127, (hkv, pages, ps, d),
                              dtype=torch.int8, generator=g),
                torch.rand((hkv, pages, ps), generator=g))
    return torch.randn((hkv, pages, ps, d), generator=g).to(dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_fake_branch_paged_attention(quant):
    from paddle_tpu_torch.kernels.paged_attention import paged_attention

    q = torch.randn(2, 4, 64)
    kp, vp = _pages(quant), _pages(quant)
    tables = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    lens = torch.tensor([5, 17], dtype=torch.int32)
    before = (_build.launch_counts(), _build.variant_counts())
    nodes, outs = _kernel_nodes(
        lambda *a: paged_attention(*a), q, kp, vp, tables, lens)
    name = "paged_attention_quant" if quant else "paged_attention"
    assert [n.op for n in nodes] == [f"kernel:{name}/cluster"]
    assert list(zip(nodes[0].out_shapes, nodes[0].out_dtypes)) == outs
    assert (_build.launch_counts(), _build.variant_counts()) == before


@pytest.mark.parametrize("batched", [False, True], ids=["chunk", "window"])
def test_fake_branch_paged_prefill(batched):
    from paddle_tpu_torch.kernels.paged_prefill import paged_prefill

    kp, vp = (_pages(dtype=torch.bfloat16), _pages(dtype=torch.bfloat16))
    if batched:
        q = torch.randn(2, 3, 4, 64).to(torch.bfloat16)
        table = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
        cache, length = (torch.tensor([4, 9], dtype=torch.int32),
                         torch.tensor([3, 2], dtype=torch.int32))
    else:
        q = torch.randn(5, 4, 64).to(torch.bfloat16)
        table = torch.tensor([0, 1, 2], dtype=torch.int32)
        cache, length = (torch.tensor(3, dtype=torch.int32),
                         torch.tensor(5, dtype=torch.int32))
    before = _build.launch_counts()
    nodes, outs = _kernel_nodes(
        lambda *a: paged_prefill(*a), q, kp, vp, table, cache, length)
    # bf16 at d 64 and page 8: the split design, as on the card
    assert [n.op for n in nodes] == ["kernel:paged_prefill/split"]
    assert list(zip(nodes[0].out_shapes, nodes[0].out_dtypes)) == outs
    assert _build.launch_counts() == before


@pytest.mark.parametrize("want_k", [False, True], ids=["q", "qk"])
def test_fake_branch_rope_kv_write_writes_the_pages(want_k):
    from paddle_tpu_torch.kernels.kv_write import rope_kv_write

    kp, vp = _pages(), _pages()
    n = 3
    q, k, v = torch.randn(n, 4, 64), torch.randn(n, 2, 64), \
        torch.randn(n, 2, 64)
    cos, sin = torch.rand(n, 32), torch.rand(n, 32)
    tables = torch.tensor([[0, 1]], dtype=torch.int32)
    rows = torch.zeros(n, dtype=torch.int32)
    pos = torch.arange(n, dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool)
    snapshot = kp.clone()
    tr = trace(lambda *a: rope_kv_write(*a, want_k=want_k),
               (q, k, v, cos, sin, kp, vp, tables, rows, pos, valid), {})
    (node,) = [n for n in tr.nodes if n.kind == "kernel"]
    assert node.op == "kernel:rope_kv_write/float"
    assert node.effect and len(node.writes) == 2     # both page tensors
    assert node.out_shapes == ((n, 4, 64),) + (((n, 2, 64),)
                                               if want_k else ())
    torch.testing.assert_close(kp, snapshot, rtol=0, atol=0)
    # the pool is an entry written in place, counted once
    assert tr.memory["alias"] == 2 * kp.numel() * 4


def test_fake_branch_flash_attention_fwd_and_bwd():
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    q = torch.randn(1, 16, 4, 64)
    k, v = torch.randn(1, 16, 2, 64), torch.randn(1, 16, 2, 64)
    nodes, outs = _kernel_nodes(lambda *a: flash_attention_fwd(*a),
                                q, k, v)
    assert [n.op for n in nodes] == ["kernel:flash_attention/tf32x3"]
    assert list(zip(nodes[0].out_shapes, nodes[0].out_dtypes)) == outs
    out, lse = flash_attention_fwd(q, k, v)
    nodes, outs = _kernel_nodes(lambda *a: flash_attention_bwd(*a),
                                q, k, v, out, lse, torch.randn_like(q))
    assert [n.op for n in nodes] == ["kernel:flash_attention_bwd/tf32x3"]
    assert list(zip(nodes[0].out_shapes, nodes[0].out_dtypes)) == outs


def test_fake_branch_grouped_matmul_and_wgrad():
    from paddle_tpu_torch.kernels import grouped_matmul as gk

    lhs = torch.randn(10, 16)
    rhs = torch.randn(3, 16, 8)
    gs = torch.tensor([4, 0, 6], dtype=torch.int32)
    nodes, outs = _kernel_nodes(lambda *a: gk._forward(*a), lhs, rhs, gs)
    assert [n.op for n in nodes] == ["kernel:grouped_matmul/fma"]
    assert list(zip(nodes[0].out_shapes, nodes[0].out_dtypes)) == outs
    g = torch.randn(10, 8)
    nodes, outs = _kernel_nodes(
        lambda *a: gk.grouped_matmul_wgrad(*a, 3), lhs, g, gs)
    assert [n.op for n in nodes] == ["kernel:grouped_matmul_wgrad/fma"]
    assert list(zip(nodes[0].out_shapes, nodes[0].out_dtypes)) == outs


def test_fake_branch_runs_no_plain_version(monkeypatch):
    from paddle_tpu_torch.kernels import paged_attention as pa

    def plain(*a, **k):
        raise AssertionError("the plain version ran inside a trace")

    monkeypatch.setattr(pa, "paged_attention_ref", plain)
    tr = trace(lambda *a: pa.paged_attention(*a),
               (torch.randn(1, 2, 64), _pages(hkv=1), _pages(hkv=1),
                torch.zeros(1, 2, dtype=torch.int32),
                torch.ones(1, dtype=torch.int32)), {})
    assert [n.op for n in tr.nodes if n.kind == "kernel"] == [
        "kernel:paged_attention/cluster"]


# ------------------------------------------------------------- serving --
def _model():
    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")


def _engine(model=None, **kw):
    cfg = dict(max_batch_slots=2, max_model_len=32, page_size=8)
    cfg.update(kw)
    return serving.Engine(model or _model(), serving.EngineConfig(**cfg))


def _counters(eng):
    m = eng.metrics
    return (m.decode_compiles, m.prefill_compiles, m.prefill_ext_compiles,
            m.cow_compiles, m.verify_compiles, _build.launch_counts(),
            _build.variant_counts(), len(jit_events.compile_log()))


class TestServingDecodeCheck:
    def test_decode_step_analyzes_clean(self):
        eng = _engine()
        before = _counters(eng)
        report = eng.check_decode(mode="error")
        assert not report.by_rule("host-sync"), report.render()
        assert not report.by_rule("retrace-hazard"), report.render()
        assert not report.by_rule("dtype-drift"), report.render()
        assert _counters(eng) == before

    def test_engine_config_gate(self):
        eng = _engine(analysis_check="error")
        assert eng.metrics.decode_compiles == 0

    def test_engine_config_rejects_bad_mode(self):
        with pytest.raises(ValueError, match="analysis_check"):
            serving.EngineConfig(analysis_check="loud")

    def test_check_decode_rejects_bad_mode(self):
        with pytest.raises(ValueError, match="check_decode mode"):
            _engine().check_decode(mode="eror")

    def test_check_decode_gates_sampling_variant_too(self, monkeypatch):
        eng = _engine()
        real = eng._decode_fn

        def poisoned(f, pool, any_sample, gen):
            fn = real(f, pool, any_sample, gen)

            def decode_fn():
                if any_sample:
                    float(f["temperature"].sum())  # sync, sampling only
                return fn()

            return decode_fn

        monkeypatch.setattr(eng, "_decode_fn", poisoned)
        with pytest.raises(AnalysisError) as ei:
            eng.check_decode(mode="error")
        assert ei.value.report.by_rule("host-sync")


class TestEngineProgramFamily:
    def _engine(self, **kw):
        # pool-dominated config (the calibration target) with a generous
        # budget: the gate runs at build and passes
        return _engine(num_blocks=512, device_memory_budget=1 << 30, **kw)

    def test_program_bytes_per_program(self):
        pb = self._engine().metrics.program_bytes
        assert "decode" in pb and "decode+sample" in pb
        assert any(k.startswith("prefill[") for k in pb)
        assert all(v > 0 for v in pb.values())

    def test_memory_gate_calibration(self):
        """The port's band: ``pool <= peak <= pool + weights +
        overhead``. A program's entry tensors are the weights, the pool
        (its ``num_blocks`` pages and the sink page) and its step buffers;
        the pool is written in place, so it is counted once (JAX's CPU
        figure counts it twice: argument and donated output). Above the
        entry tensors sit the program's transient activations. The
        overhead is therefore one pool block (the sink page) plus 1 MiB
        for the step buffers (< 1 KiB here) and the tiny model's
        activations (< 64 KiB: [slots or bucket, hidden/vocab] f32 rows,
        a [1, vocab] noise row)."""
        eng = self._engine()
        peak = max(eng.metrics.program_bytes.values())
        pool = eng.pool.per_chip_nbytes()
        weights = sum(p.numel() * p.element_size()
                      for p in eng.adapter.model.parameters())
        overhead = pool // eng.config.num_blocks + (1 << 20)
        assert pool <= peak <= pool + weights + overhead, (peak, pool)
        # every program holds the whole pool and every weight it reads
        assert min(eng.metrics.program_bytes.values()) > pool

    def test_health_exposes_budget_and_peak(self):
        eng = self._engine()
        h = eng.health()
        assert h["device_memory_budget"] == 1 << 30
        assert h["predicted_peak_bytes_per_chip"] == max(
            eng.metrics.program_bytes.values())

    def test_health_without_budget_has_no_peak(self):
        h = _engine().health()
        assert h["device_memory_budget"] is None
        assert h["predicted_peak_bytes_per_chip"] is None

    def test_metrics_view_exports_program_bytes(self):
        from paddle_tpu_torch.observability import get_registry

        eng = self._engine()
        text = get_registry().render_prometheus()
        assert "paddle_tpu_serving_program_bytes{" in text
        assert (f'engine="{eng.engine_id}",program="decode"' in text
                or f'program="decode",engine="{eng.engine_id}"' in text)

    def test_check_programs_whole_family_clean_and_isolated(self):
        eng = self._engine(enable_prefix_cache=True,
                           prefill_chunk_tokens=16, speculate_tokens=2,
                           prefill_buckets=[16, 32])
        params = serving.SamplingParams(max_new_tokens=4)
        first = [o.token_ids for o in eng.generate([[1, 2, 3, 4]], params)]
        pages = [t.clone() for t in eng.pool.k + eng.pool.v]
        before = _counters(eng)
        report = eng.check_programs(mode="error")
        assert not report.errors, report.render()
        assert not report.by_rule("unexpected-collective")
        assert not report.by_rule("memory-budget")
        assert _counters(eng) == before
        for a, b in zip(pages, eng.pool.k + eng.pool.v):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        again = [o.token_ids for o in eng.generate([[1, 2, 3, 4]], params)]
        assert again == first

    def test_check_programs_rejects_bad_mode(self):
        with pytest.raises(ValueError, match="check_programs mode"):
            _engine().check_programs(mode="eror")

    def test_delegates_still_work(self):
        eng = _engine()
        assert isinstance(eng.check_decode(mode="error"), analysis.Report)
        assert isinstance(eng.check_prefill(mode="warn"), analysis.Report)
        with pytest.raises(RuntimeError, match="speculate_tokens"):
            eng.check_verify(mode="warn")

    def test_census_empty_on_one_device(self):
        r = self._engine().check_compiled_programs()
        assert not r.findings, r.render()


class TestEngineMemoryBudgetGate:
    def test_oversized_config_refused_before_any_allocation(
        self, monkeypatch
    ):
        from paddle_tpu_torch.serving import kv_cache

        model = _model()

        def _no_alloc(self, *a, **kw):
            raise AssertionError(
                "KVPool allocated memory for a config the budget gate "
                "should have refused")

        monkeypatch.setattr(kv_cache.KVPool, "__init__", _no_alloc)
        with pytest.raises(AnalysisError) as ei:
            _engine(model, num_blocks=4096, prefix_cache_blocks=4096,
                    enable_prefix_cache=True,
                    device_memory_budget=1_000_000)
        fs = ei.value.report.by_rule("memory-budget")
        assert fs, ei.value.report.render()
        assert any("serving.decode" in f.message for f in fs)
        assert all("device_memory_budget=1000000" in f.message
                   for f in fs)

    def test_warn_mode_builds_with_warning(self):
        with pytest.warns(UserWarning, match="memory-budget"):
            eng = _engine(analysis_check="warn",
                          device_memory_budget=100_000)
        assert eng.pool is not None  # warned through, still serving
        out = eng.generate([[1, 2, 3]],
                           serving.SamplingParams(max_new_tokens=2))
        assert len(out[0].token_ids) == 2

    def test_budget_validation(self):
        with pytest.raises(ValueError, match="device_memory_budget"):
            serving.EngineConfig(device_memory_budget=0)

    def test_planted_faults_raise_under_error(self, monkeypatch):
        """The chip phase's planted decode programs: a host sync, a
        Python scalar frozen into the capture, a float64 upcast, each a
        blocking finding of its rule under ``"error"``."""
        eng = _engine()
        real = eng._decode_fn
        step = 2

        def plants(kind):
            def build(f, pool, any_sample, gen):
                fn = real(f, pool, any_sample, gen)

                def decode_fn():
                    nxt, logits = fn()
                    if kind == "host-sync":
                        logits = logits * logits.amax().item()
                    elif kind == "retrace-hazard":
                        nxt = nxt + step
                    else:
                        logits = logits.double()
                    return nxt, logits

                return decode_fn

            return build

        for rule in ("host-sync", "retrace-hazard", "dtype-drift"):
            monkeypatch.setattr(eng, "_decode_fn", plants(rule))
            with pytest.raises(AnalysisError) as ei:
                eng.check_decode(mode="error")
            assert ei.value.report.by_rule(rule), rule


@pytest.mark.parametrize("dtype,kv", [("bfloat16", None),
                                      ("bfloat16", "int8"),
                                      ("float16", None)],
                         ids=["bf16", "bf16_int8", "f16"])
def test_16bit_families_gate_clean(dtype, kv):
    """The serving cell's dtypes (16-bit weights and pool, f32 RoPE
    angles, sampling noise and step parameters), every program family
    on: the build gate passes with no blocking finding."""
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=dtype), device="cpu")
    eng = _engine(model, kv_cache_dtype=kv, enable_prefix_cache=True,
                  prefill_chunk_tokens=16, speculate_tokens=2,
                  prefill_buckets=[16, 32], analysis_check="error",
                  device_memory_budget=1 << 30)
    report = eng.check_programs("error")
    assert not report.errors and not report.warnings, report.render()


def test_warn_mode_is_quiet_on_a_clean_family():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = _engine(analysis_check="warn")
    assert eng.pool is not None
