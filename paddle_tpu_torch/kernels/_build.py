"""Build, load and count the port's hand-written CUDA kernels.

The counterpart of ``paddle_tpu/kernels/pallas/_compat.py``: the one
runtime every kernel of the port goes through.

* ``build(names)`` compiles each ``csrc/<name>.cu`` with ``nvcc`` for
  ``sm_90a`` into its own shared library with a plain C interface, all
  sources at once (one ``nvcc`` process per source, started together).
  The library lands under ``build/paddle_tpu_torch/`` at the root of the
  checkout, named by a hash of its source, of every shared header
  ``csrc/*.cuh`` and of the flags, so an edited source or header
  rebuilds and an unchanged one is reused. A failed build raises.
* ``load(name)`` returns the ``ctypes`` handle, building first if
  needed. Nothing is built or loaded when a module is imported.
* ``count_launch(name)`` is called by a kernel's wrapper right where it
  launches the kernel, and nowhere else; ``launch_counts()`` and
  ``reset_launch_counts()`` read and zero the counts. Counts are per
  kernel (``LAUNCHES``), not per source: ``flash_attention_bwd.cu``
  holds two kernels, counted apart, as are ``kv_write.cu``'s two entry
  points (``kv_write``, ``rope_kv_write``), and the int8 variants of
  ``paged_attention.cu`` and ``grouped_matmul.cu`` count under their own
  names. Where a function has more than one device kernel (the wgmma and
  the mma.sync flash forward, say), the wrapper also names the one it
  launched: ``variant_counts()`` reads those counts, keyed
  ``"<name>/<variant>"``. ``paged_prefill`` is counted two ways: by its
  pages (``float``, ``int8``) and by its design (``split``, ``ring``,
  ``fma``).
* A captured program (``serving.programs``) launches its kernels on
  every replay without calling their wrappers. ``record_launches(fn)``
  runs ``fn`` (a program's warm-up, or its capture) and returns the
  launches it counted, by name and by variant, taking them back out of
  the counters: the capture's record is what one replay launches, and
  ``count_replay(record)`` adds it on every replay. A program's warm-up
  launches, made once while it is built, are not counted.

There is no fallback counter: a wrapper given a CUDA tensor launches its
kernel or raises, and takes its plain PyTorch version only for a tensor
on the CPU.

* The static analyzer (``paddle_tpu_torch.analysis``) traces programs over
  fake tensors (``torch._subclasses.fake_tensor``), which allocate
  nothing. A wrapper given a fake tensor, on any device, runs its own
  input checks, makes its outputs with ``torch.empty`` at the kernel's
  shapes and returns them through ``fake_launch``, which hands the
  analyzer's recorder (``set_fake_hook``) one ``kernel:<name>/<variant>``
  node. It loads nothing, launches nothing and counts nothing, and no
  plain version runs. ``is_fake`` is the one type check this costs the
  real path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from torch._subclasses.fake_tensor import FakeTensor

__all__ = [
    "KERNELS", "LAUNCHES", "build", "load", "count_launch", "launch_counts",
    "variant_counts", "reset_launch_counts", "record_launches",
    "count_replay", "build_logs", "BUILD_DIR", "is_fake", "fake_launch",
    "set_fake_hook", "OP_NAMESPACE", "op_node", "describe_op",
    "library_digests",
]

# kernel sources, csrc/<name>.cu
KERNELS = ("paged_attention", "flash_attention", "flash_attention_bwd",
           "grouped_matmul", "grouped_matmul_bwd", "kv_write", "paged_prefill")
# launched kernels, as counted ("flash_attention" is the forward), and
# "paged_attention_ref" / "paged_prefill_ref": the plain paged attention
# and continuation attention run by name (``EngineConfig(decode_kernel=
# "xla")``), counted per call
LAUNCHES = ("paged_attention", "paged_attention_quant", "flash_attention",
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
            "grouped_matmul", "grouped_matmul_quant", "grouped_matmul_wgrad",
            "kv_write",
            "rope_kv_write", "paged_prefill", "paged_attention_ref",
            "paged_prefill_ref")

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict = {}
_logs: dict = {}
_launches = {name: 0 for name in LAUNCHES}
_variants: dict = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built"
        )
    return found


def _digest(name):
    """sha256 of ``csrc/<name>.cu``, every shared header and the flags:
    what the library's file name carries."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):   # any may be included
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name):
    return (CSRC_DIR / f"{name}.cu",
            BUILD_DIR / f"{name}-{_digest(name)}.so")


def library_digests():
    """``{kernel: digest}`` of every kernel library as the sources in the
    checkout would build it (the compile cache's environment)."""
    return {name: _digest(name) for name in KERNELS}


def build(names=KERNELS):
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` per source, all running at once. Raises ``RuntimeError``
    with the compiler's output if any of them fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        _logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def build_logs():
    """nvcc output (including ``ptxas -v`` register and shared-memory
    reports) of the builds this process ran, by kernel name."""
    return dict(_logs)


def load(name):
    """The ``ctypes`` library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        _, out = _target(name)
        if not out.exists():
            build([name])
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
    return lib


def count_launch(name, *variants):
    """One launch of kernel ``name``, also counted under each of
    ``variants`` (``"<name>/<variant>"``): its device kernel, and where a
    function is counted two ways (``paged_prefill``: the page variant and
    the design), both."""
    _launches[name] += 1
    for variant in variants:
        key = f"{name}/{variant}"
        _variants[key] = _variants.get(key, 0) + 1


def launch_counts():
    return dict(_launches)


def variant_counts():
    """Launches by device kernel, ``{"<name>/<variant>": n}``, for the
    functions whose wrapper chooses among several."""
    return dict(_variants)


def reset_launch_counts():
    for name in _launches:
        _launches[name] = 0
    _variants.clear()


def record_launches(fn):
    """Run ``fn()`` and return the launches it counted, ``{"<name>": n,
    "<name>/<variant>": n}`` (non-zero entries only); the counters are
    left as they were before the call."""
    launches, variants = dict(_launches), dict(_variants)
    try:
        fn()
    finally:
        record = {k: n - launches[k] for k, n in _launches.items()
                  if n != launches[k]}
        record.update({k: n - variants.get(k, 0) for k, n in _variants.items()
                       if n != variants.get(k, 0)})
        _launches.update(launches)
        _variants.clear()
        _variants.update(variants)
    return record


def count_replay(record):
    """Count one replay of a program whose capture ``record_launches``
    recorded."""
    for key, n in record.items():
        if "/" in key:
            _variants[key] = _variants.get(key, 0) + n
        else:
            _launches[key] += n


_fake_hook = None


def is_fake(t):
    """``t`` is a fake tensor (the analyzer's trace): the wrapper takes its
    analysis branch, whatever the device."""
    return isinstance(t, FakeTensor)


def set_fake_hook(hook):
    """Install the analyzer's recorder for ``fake_launch`` (None removes
    it); returns the previous one."""
    global _fake_hook
    prev, _fake_hook = _fake_hook, hook
    return prev


def fake_launch(name, variant, outputs, reads=(), writes=()):
    """A kernel wrapper's analysis branch: hand the recorder one
    ``kernel:<name>/<variant>`` node (the tensors the kernel reads, the
    outputs it makes, the pages it writes in place) and return
    ``outputs``. Counts nothing."""
    if _fake_hook is not None:
        _fake_hook(name, variant, outputs, reads, writes)
    return outputs


#: the ``torch.library`` namespace of the hand kernels registered as ops
OP_NAMESPACE = "paddle_tpu_torch"
_op_nodes: dict = {}


def op_node(op, describe):
    """Register how a call of ``OP_NAMESPACE::<op>`` is named in the
    analyzer's trace: ``describe(*args)`` -> ``(name, variant)``, the
    kernel the op's body would launch on these arguments."""
    _op_nodes[op] = describe


def describe_op(op, args):
    """``(name, variant)`` of one call of op ``op`` on ``args``."""
    return _op_nodes[op](*args)
