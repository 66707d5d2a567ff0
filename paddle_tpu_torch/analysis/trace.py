"""Tracing harness: record a function's ops WITHOUT executing them.

Counterpart of ``paddle_tpu/analysis/trace.py``, where a function becomes
a closed jaxpr. Here the function runs once under
``torch._subclasses.fake_tensor.FakeTensorMode``: every tensor is a fake
that carries its shape, dtype and device and allocates nothing, so no
kernel runs, nothing is captured and no device memory moves. A
``TorchDispatchMode`` above the fake mode records every aten op as a
``Node``: its name, its input and output tensors (by identity), the
tensors it writes in place (the schema's write aliases), the Python
scalars it was handed, the dtypes and shapes it made, and the source
line that issued it (the innermost frame in the analyzed function's
file, else the innermost frame outside torch and this package).

* The tensors handed in (``args``/``kwargs``) become fakes through
  ``FakeTensorMode.from_tensor``, which keeps each one's device and
  allocates nothing. Tensors the function reaches on its own (a model's
  parameters, a pool's pages) enter as they are used, through the same
  converter. Both are the program's entry tensors.
* The port's hand-written kernels are not run: each wrapper, given a fake
  tensor on any device, runs its own input checks, makes its outputs
  with ``torch.empty`` at the kernel's shapes, and records one
  ``kernel:<name>/<variant>`` node through ``kernels._build.fake_launch``
  (reads, outputs, and the pages it writes in place). The kernels
  registered as ``torch.library`` ops (``kernels._build.OP_NAMESPACE``)
  reach the recorder as one op each: their fake implementation makes the
  outputs and the recorder turns the call into the same kernel node
  (``_build.describe_op`` names it). Nothing is counted and no plain
  version runs, so the memory the trace sees is the kernel's.
* A data-dependent op (``.item()``, tensor truthiness, ``nonzero``, a
  masked select) cannot run on a fake: it is recorded as a host-sync
  point at its source line and answered with a placeholder (0, or an
  empty tensor of the largest shape it could have) so the trace goes on.
  So is a copy to the CPU from another device, which runs. ``.numpy()``
  on a fake cannot answer at all: it ends the trace as a host-sync point,
  as a graph break ends JAX's.

Memory (``TraceResult.memory``): the entry tensors' storages are
counted once each from the start; every storage an op makes is counted,
rounded up to the CUDA caching allocator's 512-byte granularity, from
that op until its last reference goes (for a temporary, its last use),
which is when the allocator gets the block back in eager PyTorch. A view
or an in-place write makes no storage, so the pool the programs write in
place is never counted twice. When any storage lies on a CUDA device
only CUDA storages are counted (a host constant is not device memory).

Trace crashes are the caller's to isolate (``analysis.check_call``).
"""
from __future__ import annotations

import functools
import inspect
import os
import sys
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import (
    DataDependentOutputException,
    DynamicOutputShapeException,
    FakeTensor,
    FakeTensorMode,
)
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import _build
from .findings import Finding, Severity

__all__ = ["Node", "TraceResult", "trace", "fn_location", "fake_mode",
           "ALLOC_GRANULE", "trace_count"]

#: the CUDA caching allocator rounds every block up to this many bytes
ALLOC_GRANULE = 512

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_SELF_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep
_BUILD_FILE = os.path.abspath(_build.__file__)
# ops that ask a tensor's value on the host, or whose output shape needs it
_SCALAR_OPS = ("_local_scalar_dense",)
_LIFT_OPS = ("lift_fresh", "lift_fresh_copy")


@functools.lru_cache(maxsize=4096)
def _abspath(file_name):
    return os.path.abspath(file_name)


@functools.lru_cache(maxsize=4096)
def _is_internal_frame(file_name):
    if not file_name or file_name.startswith("<"):
        return True
    path = _abspath(file_name)
    return (path.startswith(_TORCH_DIR) or path.startswith(_SELF_DIR)
            or path == _BUILD_FILE)


def fn_location(fn):
    """(file, line) of a callable's definition (closure findings anchor
    here when no op carries better provenance)."""
    code = getattr(fn, "__code__", None)
    if code is None:
        code = getattr(getattr(fn, "__func__", None), "__code__", None)
    if code is None or code.co_filename.startswith("<"):
        return None, None
    return code.co_filename, code.co_firstlineno


def fake_mode():
    """A fresh ``FakeTensorMode`` that converts real tensors it meets
    (a model's parameters) on the fly."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def _short(func):
    """``aten.mul.Tensor`` -> ``mul``."""
    return func.overloadpacket.__name__


@dataclass
class Node:
    """One recorded op (``kind`` "op"), hand-kernel launch ("kernel"),
    host constant ("const") or host sync ("sync")."""

    op: str
    kind: str = "op"
    namespace: str = ""         # aten, c10d, _c10d_functional, ...
    inputs: tuple = ()          # tensor uids read
    outputs: tuple = ()         # tensor uids made (or returned)
    writes: tuple = ()          # tensor uids written in place
    in_keys: tuple = ()         # storages read (a view's is its base's)
    write_keys: tuple = ()      # storages written in place
    scalars: tuple = ()         # Python scalars handed to the op
    out_dtypes: tuple = ()
    out_shapes: tuple = ()
    in_dtypes: tuple = ()
    file: str | None = None
    line: int | None = None
    nbytes: int = 0             # bytes of the storages it made
    effect: bool = False        # wrote an entry tensor, or synced


@dataclass
class TraceResult:
    """What the passes read: the nodes in order, the innermost analyzed
    function, the Python scalars handed in, the program's outputs, its
    entry dtypes and its memory, and the finding that ended the trace
    early (``.numpy()`` on a fake), if any."""

    fn: object = None
    fn_file: str | None = None
    fn_line: int | None = None
    nodes: list = field(default_factory=list)
    outputs: tuple = ()
    output_keys: tuple = ()     # the outputs' storages
    arg_scalars: dict = field(default_factory=dict)
    entry_float_dtypes: set = field(default_factory=set)
    memory: dict | None = None
    break_finding: Finding | None = None

    @property
    def prefer_file(self):
        return os.path.abspath(self.fn_file) if self.fn_file else None


def _frame_location(prefer_file, frame=None):
    """Innermost frame in ``prefer_file``, else the innermost frame
    outside torch and this package."""
    f = frame if frame is not None else sys._getframe(1)
    fallback = None
    while f is not None:
        name = f.f_code.co_filename
        if not _is_internal_frame(name):
            if prefer_file and _abspath(name) == prefer_file:
                return name, f.f_lineno
            if fallback is None:
                fallback = (name, f.f_lineno)
        f = f.f_back
    return fallback if fallback is not None else (None, None)


def _traceback_location(exc, prefer_file):
    """The same choice over an exception's traceback (innermost last)."""
    file = line = fallback = None
    tb = exc.__traceback__
    while tb is not None:
        name = tb.tb_frame.f_code.co_filename
        if not _is_internal_frame(name):
            if prefer_file and os.path.abspath(name) == prefer_file:
                file, line = name, tb.tb_lineno
            else:
                fallback = (name, tb.tb_lineno)
        tb = tb.tb_next
    if file is None and fallback is not None:
        file, line = fallback
    return file, line


class _Recorder(TorchDispatchMode):
    """Records every op that reaches it (see the module), keeps the live
    storages and their bytes, and answers data-dependent ops."""

    def __init__(self, mode, prefer_file):
        super().__init__()
        self.mode = mode
        self.prefer_file = prefer_file
        self.nodes = []
        self._uids = WeakIdKeyDictionary()
        self._next = 0
        self.entry = {}       # storage key -> (bytes, device type)
        self.written = {}     # entry storages written in place, likewise
        self.made = {}        # storage key -> (ref, bytes, device type)
        self.live = {}        # device type -> bytes of made storages
        self.peak = {}        # device type -> max of live
        self.float_dtypes = set()
        self._held = []

    # -- identities ----------------------------------------------------------
    def uid(self, t):
        u = self._uids.get(t)
        if u is None:
            u = self._uids[t] = self._next
            self._next += 1
        return u

    @staticmethod
    def _key(t):
        return StorageWeakRef(t.untyped_storage()).cdata

    def enter(self, t):
        """Register a tensor that existed before the trace (an argument,
        a parameter, a pool page): its storage counts from the start."""
        if not isinstance(t, FakeTensor):
            t = self.mode.from_tensor(t)
        key = self._key(t)
        if key not in self.entry and key not in self.made:
            self.entry[key] = (t.untyped_storage().nbytes(), t.device.type)
            # held for the trace: the converter keeps its fakes weakly,
            # and a freed storage's address could name the next one
            self._held.append(t)
        if t.is_floating_point():
            self.float_dtypes.add(t.dtype)
        return t

    def _free_expired(self):
        for key, (ref, nbytes, dev) in list(self.made.items()):
            if ref.expired():
                del self.made[key]
                self.live[dev] -= nbytes

    def _made(self, t):
        """Count ``t``'s storage if no op or entry tensor owns it yet;
        returns the bytes it added."""
        key = self._key(t)
        got = self.made.get(key)
        if got is not None and got[0].expired():
            # a storage freed inside this op, its address taken again
            del self.made[key]
            self.live[got[2]] -= got[1]
        if key in self.entry or key in self.made:
            return 0
        raw = t.untyped_storage().nbytes()
        nbytes = -(-raw // ALLOC_GRANULE) * ALLOC_GRANULE
        dev = t.device.type
        self.made[key] = (StorageWeakRef(t.untyped_storage()), nbytes, dev)
        self.live[dev] = self.live.get(dev, 0) + nbytes
        self.peak[dev] = max(self.peak.get(dev, 0), self.live[dev])
        return nbytes

    # -- recording -----------------------------------------------------------
    def _record(self, node):
        node.file, node.line = _frame_location(self.prefer_file)
        self.nodes.append(node)
        return node

    def kernel(self, name, variant, outputs, reads, writes):
        """``kernels._build.fake_launch``'s hook: one hand-kernel node."""
        if isinstance(outputs, torch.Tensor):
            outputs = (outputs,)
        outs = [t for t in outputs if isinstance(t, torch.Tensor)]
        for t in (*reads, *writes):
            if isinstance(t, torch.Tensor) and not self._known(t):
                self.enter(t)
        self._record(Node(
            op=f"kernel:{name}/{variant}", kind="kernel",
            inputs=tuple(self.uid(t) for t in reads
                         if isinstance(t, torch.Tensor)),
            outputs=tuple(self.uid(t) for t in outs),
            writes=tuple(self.uid(t) for t in writes
                         if isinstance(t, torch.Tensor)),
            in_keys=tuple(self._key(t) for t in reads
                          if isinstance(t, torch.Tensor)),
            write_keys=tuple(self._key(t) for t in writes
                             if isinstance(t, torch.Tensor)),
            out_dtypes=tuple(t.dtype for t in outs),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            effect=self._note_writes(writes),
        ))

    def _note_writes(self, writes):
        """Remember the entry storages ``writes`` lands in; True if any."""
        hit = False
        for t in writes:
            if isinstance(t, torch.Tensor):
                key = self._key(t)
                if key in self.entry:
                    self.written[key] = self.entry[key]
                    hit = True
        return hit

    def _known(self, t):
        key = self._key(t)
        return key in self.entry or key in self.made

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":
            return func(*args, **kwargs)
        self._free_expired()
        name = _short(func)
        if func.namespace == _build.OP_NAMESPACE:
            return self._kernel_op(func, name, args, kwargs)
        flat, _ = tree_flatten((args, kwargs))
        lift = name in _LIFT_OPS
        ins = []
        if not lift:   # a host constant's data is not an entry tensor
            for a in flat:
                if isinstance(a, torch.Tensor):
                    # tensors from before the trace (parameters reached
                    # through a module, pages through the pool) enter in
                    # the fake mode's own conversion, so their views share
                    # the counted storage
                    if not isinstance(a, FakeTensor) or not self._known(a):
                        a = self.enter(a)
                    ins.append(a)
        node = Node(
            op=name, kind="const" if lift else "op",
            namespace=func.namespace,
            inputs=tuple(self.uid(t) for t in ins),
            in_keys=tuple(self._key(t) for t in ins),
            scalars=tuple(a for a in flat if type(a) in (bool, int, float)),
            in_dtypes=tuple(t.dtype for t in ins),
        )
        writes = []
        for arg, value in zip(func._schema.arguments, args):
            info = arg.alias_info
            if (info is not None and info.is_write
                    and isinstance(value, torch.Tensor)):
                writes.append(value)
        for arg in func._schema.arguments[len(args):]:
            info, value = arg.alias_info, kwargs.get(arg.name)
            if (info is not None and info.is_write
                    and isinstance(value, torch.Tensor)):
                writes.append(value)
        try:
            out = func(*args, **kwargs)
        except (DataDependentOutputException,
                DynamicOutputShapeException):
            return self._sync(func, name, args, node)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        node.outputs = tuple(self.uid(t) for t in outs)
        node.writes = tuple(self.uid(t) for t in writes)
        node.write_keys = tuple(self._key(t) for t in writes)
        node.out_dtypes = tuple(t.dtype for t in outs)
        node.out_shapes = tuple(tuple(t.shape) for t in outs)
        node.nbytes = sum(self._made(t) for t in outs)
        node.effect = self._note_writes(writes)
        if name in ("_to_copy", "copy_") and self._to_host(name, ins, outs):
            node.kind, node.effect = "sync", True
        self._record(node)
        return out

    def _kernel_op(self, func, name, args, kwargs):
        """A hand kernel registered as an op: its fake implementation
        makes the outputs (counted as made here), and the call becomes
        one kernel node reading every tensor argument."""
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        nbytes = sum(self._made(t) for t in outs)
        reads = [a for a in tree_flatten((args, kwargs))[0]
                 if isinstance(a, torch.Tensor)]
        self.kernel(*_build.describe_op(name, args), outs, reads, ())
        self.nodes[-1].nbytes = nbytes
        return out

    @staticmethod
    def _to_host(name, ins, outs):
        """A copy that lands on the CPU from another device."""
        if name == "_to_copy":
            src, dst = ins[0], outs[0]
        else:
            dst, src = ins[0], ins[1]
        return dst.device.type == "cpu" and src.device.type != "cpu"

    def _sync(self, func, name, args, node):
        """A data-dependent op: a host-sync node and a placeholder."""
        node.kind, node.effect = "sync", True
        self._record(node)
        if name in _SCALAR_OPS:
            t = args[0]
            if t.dtype == torch.bool:
                return False
            return 0.0 if t.is_floating_point() or t.is_complex() else 0
        t = args[0]
        if name == "nonzero":
            shape = (t.numel(), t.dim())
            return torch.empty(shape, dtype=torch.long, device=t.device)
        if name == "masked_select":
            return torch.empty((t.numel(),), dtype=t.dtype, device=t.device)
        raise DynamicOutputShapeException(func)

    # -- results -------------------------------------------------------------
    def memory(self, outputs):
        """The program's bytes (see the module), in the L3 summary's
        keys."""
        self._free_expired()
        devs = {dev for _, dev in self.entry.values()}
        devs |= {dev for _, _, dev in self.made.values()} | set(self.peak)
        kinds = {"cuda"} if "cuda" in devs else devs

        def counted(dev):
            return dev in kinds

        argument = sum(b for b, dev in self.entry.values() if counted(dev))
        peak = argument + sum(v for dev, v in self.peak.items()
                              if counted(dev))
        seen, out_new = set(), 0
        for t in outputs:
            key = self._key(t)
            if key in seen:
                continue
            seen.add(key)
            if key in self.entry:
                continue
            got = self.made.get(key)
            if got is not None and counted(got[2]):
                out_new += got[1]
        alias = sum(b for b, dev in self.written.values() if counted(dev))
        return {
            "argument": argument,
            "output": out_new + alias,
            "temp": max(peak - argument - out_new, 0),
            "alias": alias,
            "generated_code": 0,
            "peak": peak,
        }


def _fakeify(rec, value):
    def conv(x):
        if isinstance(x, torch.Tensor):
            return rec.enter(x)
        return x

    return tree_map(conv, value)


_traces = 0


def trace_count():
    """How many traces this process has run (a warm engine build from
    the compile cache runs none)."""
    return _traces


def trace(fn, args, kwargs, static_argnums=(), fake=None):
    """Run ``fn(*args, **kwargs)`` over fake tensors and record it (see
    the module) -> ``TraceResult``. ``static_argnums``: positional
    arguments handed over as they are (not made fake); ``fake``: the
    ``FakeTensorMode`` whose fakes ``fn`` already closes over (a fresh
    one by default)."""
    global _traces
    _traces += 1
    inner = inspect.unwrap(getattr(fn, "__func__", fn))
    result = TraceResult(fn=inner)
    result.fn_file, result.fn_line = fn_location(inner)
    static = set(static_argnums)
    try:
        sig = inspect.signature(fn)
        bound = sig.bind_partial(*args, **kwargs).arguments
    except (TypeError, ValueError):
        bound = {}
    result.arg_scalars = {
        name: v for name, v in bound.items()
        if type(v) in (bool, int, float)
    }
    mode = fake if fake is not None else fake_mode()
    rec = _Recorder(mode, result.prefer_file)
    with mode:
        call_args = [a if i in static else _fakeify(rec, a)
                     for i, a in enumerate(args)]
        call_kwargs = {k: _fakeify(rec, v) for k, v in kwargs.items()}
    hook = _build.set_fake_hook(rec.kernel)
    out = None
    try:
        with torch.no_grad(), mode, rec:
            out = fn(*call_args, **call_kwargs)
    except RuntimeError as e:
        if ".numpy() is not supported" not in str(e):
            raise
        file, line = _traceback_location(e, result.prefer_file)
        result.break_finding = Finding(
            rule="host-sync",
            severity=Severity.ERROR,
            message=(
                "tensor value taken to the host (.numpy()): a capture "
                "cannot read a device value while it records; keep the "
                "data on the device or hoist it out of the captured "
                "region"
            ),
            file=file,
            line=line,
            op="numpy",
        )
    finally:
        _build.set_fake_hook(hook)
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    result.nodes = rec.nodes
    result.outputs = tuple(rec.uid(t) for t in outs)
    result.output_keys = tuple(rec._key(t) for t in outs)
    result.entry_float_dtypes = set(rec.float_dtypes)
    result.memory = rec.memory(outs)
    return result
