"""``to_static``: staging a function or a layer forward on ``torch.compile``.

Counterpart of ``paddle_tpu/jit/api.py`` (``to_static``,
``StaticFunction``, ``not_to_static``, ``ignore_module``). JAX stages a
function into one XLA program through ``jax.jit``; here it is
``torch.compile``:

* ``full_graph=True`` (the default) is ``fullgraph=True, dynamic=False``:
  one program per input signature, as ``jax.jit``, and a function Dynamo
  cannot capture whole (a data-dependent branch) raises.
  ``full_graph=False`` is ``jit.graph_break.GraphBreakFunction``.
* ``backend=None`` is Inductor; any ``torch.compile`` backend name (the
  CPU tests use ``"aot_eager"``) or callable is taken as it is.
* Parameters and buffers are read live (Dynamo lifts a module's
  parameters to graph inputs), so a parameter update needs no recompile,
  and a layer with buffers (batch norm) updates them.
* The hand kernels are ``torch.library`` ops, so a compiled program
  keeps each flash attention and grouped GEMM call as one node and
  launches the kernel when it runs (counted as in eager).
* ``check="warn"|"error"`` runs the static analyzer
  (``paddle_tpu_torch.analysis``) over the function on the first call
  per input signature, before it compiles.
* ``cache=`` (a directory or a ``compilecache.CompileCache``; only with
  ``full_graph=True``) persists eval calls across processes. The key is
  the function's bytecode fingerprint, the abstract signature of its
  parameters, buffers and inputs, its static arguments, the layer's
  train/eval flag and a digest of Inductor's configuration at the call,
  under the environment fingerprint. A hit loads the
  stored artifacts (``torch.compiler.load_cache_artifacts``) before the
  first compile, so Inductor's FX-graph and AOTAutograd caches hit:
  Inductor generates no code and Triton compiles nothing, but Dynamo
  still traces (it is what builds the guards). ``save_cache_artifacts``
  returns everything compiled in the process so far, not one function:
  the artifact stored under a signature's key holds those bytes, and
  their size is counted (``metrics.bytes_written``). Training calls
  (gradients needed) bypass the cache, and so does a static argument
  with no stable fingerprint (an address in its repr), which warns once.

Every backend compile is logged (``observability.jit_events``,
``kind="to_static"``); ``StaticFunction.compiles`` counts them.
"""
from __future__ import annotations

import itertools
import re
import sys

import torch
from torch.utils import _pytree as pytree

from ..observability import jit_events

__all__ = ["to_static", "not_to_static", "ignore_module", "StaticFunction"]

_NOT_TO_STATIC = set()

# monotonic instance tokens for the compile-log signatures: two distinct
# functions sharing a name (every layer's 'forward') must not read as
# retraces of each other
_instance_tokens = itertools.count(1)

# default object.__repr__ shape: "<pkg.Cls object at 0x7f...>" — a
# process-local address that must never reach a cross-process cache key
_ADDR_REPR = re.compile(r" at 0x[0-9a-fA-F]+>")


def not_to_static(fn):
    """Mark a function to stay eager: ``to_static`` returns it as it is."""
    _NOT_TO_STATIC.add(fn)
    return fn


def ignore_module(modules):
    """API-parity no-op: Dynamo traces any module."""
    return None


def _backend(backend):
    if backend is None:
        backend = "inductor"
    if isinstance(backend, str):
        return torch._dynamo.lookup_backend(backend)
    return backend


def _split(args, kwargs):
    """(static template, tensor leaves) of a call: the pytree structure
    with the non-tensor leaves, and the tensors."""
    flat, spec = pytree.tree_flatten((args, kwargs))
    tensors = [x for x in flat if isinstance(x, torch.Tensor)]
    template = (str(spec), repr(tuple(
        None if isinstance(x, torch.Tensor) else x for x in flat)))
    return template, tensors


class StaticFunction:
    """A function (or a layer's forward) staged through ``torch.compile``
    (see the module). ``compiles`` counts the backend compiles."""

    def __init__(self, function, layer=None, check=None, cache=None,
                 backend=None, full_graph=True):
        if check not in (None, "warn", "error"):
            raise ValueError(
                f'check must be None, "warn" or "error", got {check!r}'
            )
        self._function = function
        self._layer = layer
        self._check = check
        self._checked_sigs = set()
        self._name = getattr(function, "__name__", "staged_fn")
        self._instance_tok = next(_instance_tokens)
        self._real_backend = _backend(backend)
        self._watch_sig = ""
        self.compiles = 0
        self._compiled = torch.compile(function, backend=self._compile,
                                       fullgraph=full_graph, dynamic=False)
        # persistent compile cache (paddle_tpu_torch.compilecache):
        # resolved lazily
        self._cache_spec = cache
        self._cc = None
        self._code_fp = None
        self._cache_sigs = set()   # signatures this instance has keyed
        self._warned_unstable = False

    def _compile(self, gm, example_inputs):
        """The backend, counted and logged once per compiled graph."""
        self.compiles += 1
        with jit_events.watch(self._name, kind="to_static",
                              signature=self._watch_sig):
            return self._real_backend(gm, example_inputs)

    def _state(self):
        if self._layer is None:
            return [], []
        return (list(self._layer.parameters()),
                list(self._layer.buffers()))

    def _run_check(self, args, kwargs, sig):
        """``to_static(check=...)``: on the first call per input
        signature, run the static analyzer over the function (a trace
        over fake tensors, nothing executes) and warn or raise per mode
        BEFORE it compiles."""
        if sig in self._checked_sigs:
            return
        from .. import analysis

        report = analysis.check_call(self._function, args, kwargs,
                                     mode=self._check)
        analysis.enforce(
            report, self._check,
            what=f"to_static(check={self._check!r}) analysis of "
            f"{self._name!r}",
        )
        # marked checked only on a pass: a blocking finding re-raises on
        # every call
        self._checked_sigs.add(sig)

    def _cache_key(self, template, tensors):
        """``(name, signature, store key)`` of this call for the disk
        cache, or None when its static arguments have no stable repr."""
        from .. import compilecache as cc_mod
        from ..compilecache.aot import inductor_config_digest

        if self._cc is None:
            self._cc = cc_mod.resolve(self._cache_spec)
            self._code_fp = cc_mod.code_fingerprint(self._function) or ""
        cache_name = f"to_static.{self._name}"
        meta_token = repr(template)
        if not self._code_fp or _ADDR_REPR.search(meta_token):
            if self._code_fp and not self._warned_unstable:
                self._warned_unstable = True
                sys.stderr.write(
                    f"[compilecache] {cache_name}: a static argument has "
                    "no stable repr (address-bearing); this signature is "
                    "compiled per process, not disk-cached\n"
                )
            return None
        params, buffers = self._state()
        mode = getattr(self._layer, "training", None)
        sig = (
            f"to_static:{self._code_fp}:"
            + cc_mod.signature_str((cc_mod.abstractify(params),
                                    cc_mod.abstractify(buffers),
                                    cc_mod.abstractify(tensors)))
            + f":meta={meta_token}:mode={mode}"
            + f":inductor={inductor_config_digest()}"
        )
        return cache_name, sig, self._cc.key(cache_name, sig)

    def __call__(self, *args, **kwargs):
        template, tensors = _split(args, kwargs)
        params, _ = self._state()
        training = torch.is_grad_enabled() and any(
            p.requires_grad for p in params)
        sig = (template, tuple((tuple(t.shape), t.dtype, t.device.type)
                               for t in tensors),
               getattr(self._layer, "training", None), training)
        if self._check is not None:
            self._run_check(args, kwargs, sig)
        self._watch_sig = (f"{self._instance_tok:x}:"
                           f"{hash(sig) & 0xFFFFFFFF:08x}:"
                           f"{'train' if training else 'eval'}")
        store = None
        if (self._cache_spec is not None and not training
                and sig not in self._cache_sigs):
            # first eval call of this signature: restore its artifacts
            # before the compile, or store them after it
            self._cache_sigs.add(sig)
            keyed = self._cache_key(template, tensors)
            if keyed is not None:
                name, csig, key = keyed
                if self._cc.load_executable(key, name=name,
                                            signature=csig) is None:
                    store = keyed
        out = self._compiled(*args, **kwargs)
        if store is not None:
            name, csig, key = store
            self._cc.store_executable(key, name=name, signature=csig)
        return out


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, check=None, cache=None,
              **kwargs):
    """Decorator/wrapper staging a function or a layer (see the module).

    ``input_spec``/``build_strategy`` are accepted for API parity; shapes
    are taken from each call (one program per input signature).

    A layer is returned with its ``forward`` replaced by the staged one;
    a function marked ``not_to_static`` is returned as it is.
    """
    if check is not None and not full_graph:
        raise ValueError(
            "check= requires full_graph=True (the graph-break fallback "
            "intentionally tolerates host syncs)"
        )
    if cache is not None and not full_graph:
        raise ValueError(
            "cache= requires full_graph=True (graph-break segments "
            "compile per branch and are not one program)"
        )

    def _wrap(obj):
        if isinstance(obj, torch.nn.Module):
            if full_graph:
                sf = StaticFunction(obj.forward, layer=obj, check=check,
                                    cache=cache, backend=backend)
            else:
                from .graph_break import GraphBreakFunction

                sf = GraphBreakFunction(obj.forward, layer=obj,
                                        backend=backend)
            obj.forward = sf
            return obj
        if obj in _NOT_TO_STATIC:
            return obj
        if not full_graph:
            from .graph_break import GraphBreakFunction

            return GraphBreakFunction(obj, backend=backend)
        return StaticFunction(obj, check=check, cache=cache,
                              backend=backend)

    if function is not None:
        return _wrap(function)
    return _wrap
