"""Level-2 trace-safety lint: AST rules over the port's own source.

Counterpart of ``paddle_tpu/analysis/astlint.py``: the same rules, rule
names, allowlist and call-graph reachability, so the two linters give the
same ``(rule, line)`` findings on the same source. The program passes
catch hazards in ONE traced program; this linter catches the source
patterns that produce them, over the whole package, without importing or
tracing anything: cheap enough to run as a tier-1 gate
(``python -m paddle_tpu_torch.analysis --self``).

Rules:

    broad-except       ``except Exception: pass`` (or bare ``except:``)
                       silently swallowing everything: narrow it to the
                       expected types or annotate why it must be broad
    nondet-in-traced   ``time.time()`` / ``np.random.*`` inside a
                       function reachable from a traced region: the
                       value is read once while the program is captured
                       and the CUDA graph replays it on every step
    host-sync-in-traced  a host round-trip inside a traced-reachable
                       function: torch's sync points (``.item()``,
                       ``.tolist()``, ``.cpu()``, ``.numpy()``,
                       ``.synchronize()``, and tensor truthiness:
                       ``bool()``/``float()``/``int()`` of a reduction,
                       or a reduction in an ``if``/``while``/``assert``
                       test) and JAX's (``jax.device_get(...)``,
                       ``.block_until_ready()``). A sync fails a CUDA
                       graph capture and stalls the pipeline when eager.
                       Deliberate breaks carry an allow comment.
    global-mutation    ``global`` declaration inside a traced-reachable
                       function: module state mutated while the program
                       is captured, not per replay
    unlocked-shared-mutation  a ``self.attr`` assignment reachable from
                       MORE THAN ONE thread root of a threaded class
                       (a method passed to ``threading.Thread(target=
                       self...)`` is one root; the class's public
                       methods, the caller's thread, are another)
                       without a ``with self._lock`` guard around the
                       write. Writes in ``__init__`` (pre-thread) and
                       classes that spawn no threads are exempt; reads
                       are deliberately not tracked (precision over
                       recall).
    falsy-zero-guard   ``x or default`` where ``x`` is a timestamp /
                       counter / size that legitimately holds 0, either
                       named like one (``since``/``now``/``deadline``/
                       ``*_ts``/``*_at``/``*_time``...) or assigned from
                       ``time.*()`` / ``len()`` in the same function.
                       ``0 or default`` silently takes the default (the
                       autoscaler hysteresis bug shape: ``since or now``
                       resetting a hold window every probe). Use
                       ``x if x is not None else default``.

"Traced region" is approximated conservatively (precision over recall).
The roots are the bodies that are captured into a CUDA graph or compiled:

  * functions decorated with ``to_static``/``jit``/``bucketize``/
    ``TrainStep`` (JAX's decorator roots, kept for parity);
  * the serving adapter's ``prefill``, ``prefill_ext``, ``decode`` and
    ``verify`` (``serving/adapter.py``) and ``jit.TrainStep``'s step
    (``jit/train_step.py``);
  * every function a ``Program`` captures (``serving/programs.py``): the
    first argument of a ``Program(...)`` or ``self._program(...)`` call,
    a nested function named there, or the same-module function or method
    whose call builds it (the builder's nested bodies are its own).

Reachability follows same-module direct calls (``name(...)`` to a module
function, ``self.name(...)`` to a method of the same class).

Allowlist: a violation is suppressed by a comment on the offending line
(or the line above)::

    except Exception:
        pass  # analysis: allow(broad-except) reason why this is safe
"""
from __future__ import annotations

import ast
import os
import re

from .findings import Finding, Severity

__all__ = ["lint_source", "lint_paths", "self_lint", "package_root"]

_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\(([a-zA-Z0-9_\-, ]+)\)")

# decorator names that mark a function as a trace root
_ROOT_DECORATORS = {"to_static", "jit", "bucketize", "TrainStep"}
# package-relative files and the functions in them that are traced
# bodies: the serving adapter's entry points (every serving program runs
# one) and the training step
_ROOT_FUNCTIONS = {
    os.path.join("serving", "adapter.py"): frozenset({
        "LlamaServingAdapter.prefill", "LlamaServingAdapter.prefill_ext",
        "LlamaServingAdapter.decode", "LlamaServingAdapter.verify",
    }),
    os.path.join("jit", "train_step.py"): frozenset({"TrainStep.__call__"}),
}
# calls whose first argument is a function captured into a CUDA graph
_CAPTURE_CALLS = {"Program", "_program"}
# torch's host sync points: tensor methods, and reductions whose value a
# bool()/float()/int() or a branch test takes to the host
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_REDUCTIONS = {"sum", "mean", "max", "min", "amax", "amin", "any", "all",
               "norm", "prod", "equal", "allclose"}
_SCALAR_CASTS = {"bool", "float", "int"}
_TIME_FNS = {"time", "time_ns", "monotonic", "monotonic_ns",
             "perf_counter", "perf_counter_ns"}
# attribute names that look like synchronization primitives: writes
# under `with self._lock:` (or any *lock*/*mutex*/*cond* name) count as
# guarded, and the primitives themselves are never "shared mutations"
_LOCK_NAME_RE = re.compile(r"lock|mutex|cond", re.IGNORECASE)
# value names that legitimately hold 0: timestamps, counters, sizes —
# the `x or default` falsy trap (falsy-zero-guard)
_FALSY_ZERO_NAME_RE = re.compile(
    r"(^|_)(since|now|ts|t0|deadline|elapsed)($|_)"
    r"|_(at|time|started|seen|count|bytes|size)$"
)


def _allowed(lines, lineno, rule, end=None):
    """Allow-comment on the line, the line above, or (when ``end`` is
    given) anywhere in the [lineno, end] range — comment blocks between
    an ``except`` and its ``pass`` count."""
    for ln in range(lineno - 1, (end or lineno) + 1):
        if 1 <= ln <= len(lines):
            m = _ALLOW_RE.search(lines[ln - 1])
            if m and rule in {r.strip() for r in m.group(1).split(",")}:
                return True
    return False


def _is_pass_body(body):
    return all(
        isinstance(stmt, ast.Pass)
        or (isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is Ellipsis)
        for stmt in body
    )


def _names_in(node):
    """Dotted-name heads mentioned anywhere in a decorator expression."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


class _Module:
    """One parsed file: function table, call graph, import aliases."""

    def __init__(self, tree):
        self.functions = {}   # qualname -> FunctionDef
        self.classes = {}     # class name -> {method name -> qualname}
        self.time_aliases = set()     # names bound to the time module
        self.np_aliases = set()       # names bound to numpy
        self.np_random_aliases = set()  # names bound to numpy.random
        self.jax_aliases = set()      # names bound to the jax module
        self.device_get_aliases = set()  # from jax import device_get
        # nested functions a Program captures: qualname -> FunctionDef
        # (kept apart from ``functions``, whose bodies already hold them)
        self.nested = {}
        self._collect(tree)

    def lookup(self, qual):
        return self.functions.get(qual) or self.nested.get(qual)

    def _collect(self, tree):
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._imports(node)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                methods = {}
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        qual = f"{node.name}.{sub.name}"
                        self.functions[qual] = sub
                        methods[sub.name] = qual
                self.classes[node.name] = methods

    def _imports(self, node):
        if isinstance(node, ast.Import):
            for alias in node.names:
                bound = alias.asname or alias.name.split(".")[0]
                if alias.name == "time":
                    self.time_aliases.add(bound)
                elif alias.name == "jax":
                    self.jax_aliases.add(bound)
                elif alias.name == "numpy":
                    self.np_aliases.add(bound)
                elif alias.name == "numpy.random":
                    # `import numpy.random` binds `numpy`
                    if alias.asname:
                        self.np_random_aliases.add(alias.asname)
                    else:
                        self.np_aliases.add("numpy")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "numpy":
                for alias in node.names:
                    if alias.name == "random":
                        self.np_random_aliases.add(
                            alias.asname or alias.name
                        )
            elif node.module == "jax":
                for alias in node.names:
                    if alias.name == "device_get":
                        self.device_get_aliases.add(
                            alias.asname or alias.name
                        )


def _roots(mod, relpath):
    roots = set()
    by_path = _ROOT_FUNCTIONS.get(relpath, frozenset())
    for qual, node in mod.functions.items():
        if qual in by_path:
            roots.add(qual)
            continue
        for dec in node.decorator_list:
            if _names_in(dec) & _ROOT_DECORATORS:
                roots.add(qual)
                break
    roots |= _captured_roots(mod)
    return roots


def _captured_roots(mod):
    """What a ``Program(fn, ...)`` / ``self._program(fn, ...)`` call
    captures: a nested function ``fn`` of the calling function (recorded
    in ``mod.nested``), a module function, or the function or method
    whose call builds ``fn``."""
    roots = set()
    for qual, node in list(mod.functions.items()):
        cls = qual.split(".")[0] if "." in qual else None
        methods = mod.classes.get(cls, {})
        local = {
            sub.name: sub for sub in ast.walk(node)
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
            and sub is not node
        }
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Call) and sub.args):
                continue
            f = sub.func
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None)
            if name not in _CAPTURE_CALLS:
                continue
            arg = sub.args[0]
            if isinstance(arg, ast.Call):
                arg = arg.func   # the builder of the captured function
            target = None
            if isinstance(arg, ast.Name):
                if arg.id in local:
                    target = f"{qual}.{arg.id}"
                    mod.nested[target] = local[arg.id]
                elif arg.id in mod.functions:
                    target = arg.id
            elif (isinstance(arg, ast.Attribute)
                    and isinstance(arg.value, ast.Name)
                    and arg.value.id == "self" and arg.attr in methods):
                target = methods[arg.attr]
            if target is not None:
                roots.add(target)
    return roots


def _edges(mod, qual, node):
    """Same-module call targets of one function (conservative)."""
    cls = qual.split(".")[0] if "." in qual else None
    methods = mod.classes.get(cls, {})
    out = set()
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        if isinstance(f, ast.Name) and f.id in mod.functions:
            out.add(f.id)
        elif (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
                and f.attr in methods):
            out.add(methods[f.attr])
    return out


def _reachable(mod, roots):
    seen = set(roots)
    frontier = list(roots)
    while frontier:
        qual = frontier.pop()
        node = mod.lookup(qual)
        if node is None:
            continue
        for nxt in _edges(mod, qual, node):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return seen


def _broad_except(tree, lines, filename):
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            broad = handler.type is None or (
                isinstance(handler.type, ast.Name)
                and handler.type.id in ("Exception", "BaseException")
            )
            if not (broad and _is_pass_body(handler.body)):
                continue
            if _allowed(lines, handler.lineno, "broad-except",
                        end=handler.body[-1].lineno):
                continue
            yield Finding(
                rule="broad-except",
                severity=Severity.WARNING,
                message=(
                    "silent `except Exception: pass` swallows every "
                    "failure (including trace breaks and injected "
                    "faults); narrow it to the expected exception types "
                    "or annotate `# analysis: allow(broad-except) "
                    "<reason>`"
                ),
                file=filename,
                line=handler.lineno,
            )


def _nondet_calls(mod, node):
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        if not isinstance(f, ast.Attribute):
            continue
        v = f.value
        # time.time() and friends
        if (isinstance(v, ast.Name) and v.id in mod.time_aliases
                and f.attr in _TIME_FNS):
            yield sub, f"{v.id}.{f.attr}()"
        # np.random.<anything>(...)
        elif (isinstance(v, ast.Attribute) and v.attr == "random"
                and isinstance(v.value, ast.Name)
                and v.value.id in mod.np_aliases):
            yield sub, f"{v.value.id}.random.{f.attr}()"
        # random.<fn>(...) where random came from numpy
        elif (isinstance(v, ast.Name) and v.id in mod.np_random_aliases):
            yield sub, f"{v.id}.{f.attr}()"


def _host_sync_calls(mod, node):
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        if isinstance(f, ast.Name):
            # device_get(...) imported from jax
            if f.id in mod.device_get_aliases:
                yield sub, f"{f.id}()"
            continue
        if not isinstance(f, ast.Attribute):
            continue
        v = f.value
        # jax.device_get(...)
        if (isinstance(v, ast.Name) and v.id in mod.jax_aliases
                and f.attr == "device_get"):
            yield sub, f"{v.id}.device_get()"
        # <anything>.block_until_ready()
        elif f.attr == "block_until_ready":
            yield sub, ".block_until_ready()"
        # torch: .item() / .tolist() / .cpu() / .numpy() / .synchronize()
        elif f.attr in _SYNC_METHODS:
            yield sub, f".{f.attr}()"
    yield from _truthiness(node)


def _is_reduction(node):
    """``<x>.sum()``-style reductions and ``torch.any(...)``-style calls:
    a tensor whose VALUE a branch or a Python scalar cast needs."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _REDUCTIONS)


def _truthiness(node):
    """Tensor truthiness: ``bool()``/``float()``/``int()`` of a
    reduction, or a reduction (alone, negated, or compared) as the test
    of an ``if``/``while``/``assert`` or a conditional expression."""
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                and sub.func.id in _SCALAR_CASTS and len(sub.args) == 1
                and _is_reduction(sub.args[0])):
            yield sub, f"{sub.func.id}() of a tensor reduction"
        elif isinstance(sub, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            test = sub.test
            if isinstance(test, ast.UnaryOp) and isinstance(
                    test.op, ast.Not):
                test = test.operand
            operands = ([test.left, *test.comparators]
                        if isinstance(test, ast.Compare) else [test])
            if any(_is_reduction(o) for o in operands):
                yield test, "tensor truthiness in a branch test"


def _traced_rules(mod, relpath, lines, filename):
    roots = _roots(mod, relpath)
    if not roots:
        return
    for qual in sorted(_reachable(mod, roots)):
        node = mod.lookup(qual)
        if node is None:
            continue
        for call, desc in _nondet_calls(mod, node):
            if _allowed(lines, call.lineno, "nondet-in-traced"):
                continue
            yield Finding(
                rule="nondet-in-traced",
                severity=Severity.WARNING,
                message=(
                    f"{desc} inside `{qual}` (reachable from a traced "
                    "region): the value is read ONCE while the program "
                    "is captured and the CUDA graph replays it on every "
                    "step; stage it into a device buffer or draw from "
                    "the program's registered generator"
                ),
                file=filename,
                line=call.lineno,
            )
        for call, desc in _host_sync_calls(mod, node):
            if _allowed(lines, call.lineno, "host-sync-in-traced"):
                continue
            yield Finding(
                rule="host-sync-in-traced",
                severity=Severity.WARNING,
                message=(
                    f"{desc} inside `{qual}` (reachable from a traced "
                    "region): a host-device round-trip on the hot path "
                    "— it fails a CUDA graph capture and stalls the "
                    "pipeline when eager; keep data on device or annotate the "
                    "deliberate break with `# analysis: "
                    "allow(host-sync-in-traced) <reason>`"
                ),
                file=filename,
                line=call.lineno,
            )
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Global):
                continue
            if _allowed(lines, sub.lineno, "global-mutation"):
                continue
            names = ", ".join(sub.names)
            yield Finding(
                rule="global-mutation",
                severity=Severity.WARNING,
                message=(
                    f"`global {names}` inside `{qual}` (reachable from "
                    "a traced region): module state mutates while the "
                    "program is captured, not per replay — replays will "
                    "not see or apply the update"
                ),
                file=filename,
                line=sub.lineno,
            )


def _thread_targets(mod, cls_name):
    """Methods of ``cls_name`` passed as ``threading.Thread(target=
    self.<m>)`` anywhere in the class — each is one thread root."""
    methods = mod.classes.get(cls_name, {})
    targets = set()
    for name in methods.values():
        node = mod.functions.get(name)
        if node is None:
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            is_thread = (
                (isinstance(f, ast.Name) and f.id == "Thread")
                or (isinstance(f, ast.Attribute) and f.attr == "Thread")
            )
            if not is_thread:
                continue
            for kw in sub.keywords:
                if (kw.arg == "target"
                        and isinstance(kw.value, ast.Attribute)
                        and isinstance(kw.value.value, ast.Name)
                        and kw.value.value.id == "self"
                        and kw.value.attr in methods):
                    targets.add(kw.value.attr)
    return targets


def _self_assignments(node):
    """(attr, lineno, guarded) for every ``self.X = / op=`` statement in
    one method, where guarded means lexically inside a ``with`` whose
    context mentions a lock-named attribute."""
    out = []

    def visit(n, guarded):
        if isinstance(n, ast.With):
            g = guarded or any(
                _LOCK_NAME_RE.search(name)
                for item in n.items
                for name in _names_in(item.context_expr)
            )
            for child in n.body:
                visit(child, g)
            return
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            return  # nested defs run on whatever thread calls them
        targets = []
        if isinstance(n, ast.Assign):
            targets = n.targets
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            targets = [n.target]
        for t in targets:
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                    and not _LOCK_NAME_RE.search(t.attr)):
                out.append((t.attr, n.lineno, guarded))
        for child in ast.iter_child_nodes(n):
            visit(child, guarded)

    for stmt in node.body:
        visit(stmt, False)
    return out


def _shared_mutation(mod, lines, filename):
    """unlocked-shared-mutation: per threaded class, find ``self.X``
    writes reachable from two or more thread roots where at least one
    write site is outside a lock guard."""
    for cls_name, methods in mod.classes.items():
        targets = _thread_targets(mod, cls_name)
        if not targets:
            continue  # class spawns no threads: single-threaded by lint
        # roots: one per Thread target + ONE for the calling thread
        # (every public method); __init__ runs before any thread starts
        roots = {f"thread:{t}": {methods[t]} for t in targets}
        callers = {
            qual for name, qual in methods.items()
            if not name.startswith("_") and name not in targets
        }
        if callers:
            roots["callers"] = callers
        reach = {
            root: _reachable(mod, quals)
            for root, quals in roots.items()
        }
        # attr -> {root ids} and the unguarded write sites
        writer_roots: dict = {}
        unguarded: dict = {}
        for name, qual in methods.items():
            if name == "__init__":
                continue
            node = mod.functions.get(qual)
            if node is None:
                continue
            my_roots = {r for r, seen in reach.items() if qual in seen}
            if not my_roots:
                continue
            for attr, lineno, guarded in _self_assignments(node):
                writer_roots.setdefault(attr, set()).update(my_roots)
                if not guarded:
                    unguarded.setdefault(attr, []).append(
                        (qual, lineno)
                    )
        for attr in sorted(writer_roots):
            rts = writer_roots[attr]
            if len(rts) < 2:
                continue
            for qual, lineno in unguarded.get(attr, []):
                if _allowed(lines, lineno, "unlocked-shared-mutation"):
                    continue
                yield Finding(
                    rule="unlocked-shared-mutation",
                    severity=Severity.WARNING,
                    message=(
                        f"`self.{attr}` is written in `{qual}` without "
                        f"a lock guard, but is reachable from "
                        f"{len(rts)} thread roots of `{cls_name}` "
                        f"({', '.join(sorted(rts))}): wrap the write "
                        "in `with self._lock:` or annotate the benign "
                        "site with `# analysis: "
                        "allow(unlocked-shared-mutation) <reason>`"
                    ),
                    file=filename,
                    line=lineno,
                )


def _falsy_zero(mod, lines, filename):
    """falsy-zero-guard: ``x or default`` over values that legitimately
    hold 0 (timestamps / counters / sizes)."""
    for qual, node in mod.functions.items():
        # names bound from time.*() or len() in this function: dataflow
        # evidence the value is a timestamp/size even if named opaquely
        zeroish = set()
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Assign)
                    and len(sub.targets) == 1
                    and isinstance(sub.targets[0], ast.Name)
                    and isinstance(sub.value, ast.Call)):
                continue
            f = sub.value.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id in mod.time_aliases
                    and f.attr in _TIME_FNS):
                zeroish.add(sub.targets[0].id)
            elif isinstance(f, ast.Name) and f.id == "len":
                zeroish.add(sub.targets[0].id)
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.BoolOp)
                    and isinstance(sub.op, ast.Or)):
                continue
            left = sub.values[0]
            if isinstance(left, ast.Name):
                name = left.id
            elif isinstance(left, ast.Attribute):
                name = left.attr
            elif (isinstance(left, ast.Call)
                    and isinstance(left.func, ast.Attribute)
                    and isinstance(left.func.value, ast.Name)
                    and left.func.value.id in mod.time_aliases
                    and left.func.attr in _TIME_FNS):
                name = f"{left.func.value.id}.{left.func.attr}()"
            else:
                continue
            if not (name in zeroish or name.endswith("()")
                    or _FALSY_ZERO_NAME_RE.search(name)):
                continue
            if _allowed(lines, sub.lineno, "falsy-zero-guard"):
                continue
            yield Finding(
                rule="falsy-zero-guard",
                severity=Severity.WARNING,
                message=(
                    f"`{name} or ...` treats 0 as missing, but "
                    f"`{name}` is a timestamp/counter/size where 0 is "
                    "a legitimate value — the `since or now` "
                    "hysteresis bug shape; use "
                    f"`{name} if {name} is not None else ...` (or "
                    "annotate `# analysis: allow(falsy-zero-guard) "
                    "<reason>`)"
                ),
                file=filename,
                line=sub.lineno,
            )


def lint_source(text, filename="<string>", relpath=None):
    """Lint one source blob; returns a list of Findings. ``relpath`` is
    the package-relative path used for path-based trace roots."""
    try:
        tree = ast.parse(text, filename=filename)
    except SyntaxError as e:
        return [Finding(
            rule="parse-error",
            severity=Severity.ERROR,
            message=f"cannot parse: {e.msg}",
            file=filename,
            line=e.lineno,
        )]
    lines = text.splitlines()
    findings = list(_broad_except(tree, lines, filename))
    mod = _Module(tree)
    findings.extend(_traced_rules(mod, relpath, lines, filename))
    findings.extend(_shared_mutation(mod, lines, filename))
    findings.extend(_falsy_zero(mod, lines, filename))
    findings.sort(key=lambda f: (f.line or 0))
    return findings


def package_root():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_paths(paths, base=None):
    """Lint files/directories (``*.py``, recursively)."""
    findings = []
    for path in paths:
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [
                    d for d in dirnames if d != "__pycache__"
                ]
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        findings.extend(
                            _lint_file(os.path.join(dirpath, name), base)
                        )
        else:
            findings.extend(_lint_file(path, base))
    return findings


def _lint_file(path, base):
    rel = os.path.relpath(path, base) if base else None
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return lint_source(text, filename=path, relpath=rel)


def self_lint():
    """Lint the installed ``paddle_tpu_torch`` package itself: the gate
    behind ``python -m paddle_tpu_torch.analysis --self``."""
    root = package_root()
    return lint_paths([root], base=root)
