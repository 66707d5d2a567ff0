"""Cache-key derivation and the compiled artifacts' (de)serialization.

Counterpart of ``paddle_tpu/compilecache/aot.py``. Key derivation is
content addressing over *(fn name, abstract signature, environment
fingerprint)*: the fingerprint pins the torch version, the CUDA runtime,
the device and its compute capability and the digests of the hand-kernel
libraries (``kernels._build.library_digests``: each source, every shared
header and the nvcc flags), so an upgraded process, another card or an
edited kernel simply misses (and re-populates) rather than loading what
another environment built. The fingerprint is also recorded in each
artifact's metadata and re-checked at load: an artifact whose recorded
environment disagrees with the running one is stale and never used.
Where JAX folds a digest of ``XLA_FLAGS`` into the environment, a
``to_static`` key here folds ``inductor_config_digest()`` into its
signature, read at the call: Inductor's configuration shapes what a
compile generates but not an engine's analysis reports, and Dynamo
rewrites part of it around every compile (``deterministic`` follows
``torch.use_deterministic_algorithms``), so it cannot be one value per
cache.

What is serialized differs from JAX's. A ``jax.stages.Compiled`` is one
executable; torch has no such object. ``serialize_compiled`` returns the
bytes of ``torch.compiler.save_cache_artifacts()``: Inductor's FX-graph
and AOTAutograd cache entries (with the Triton kernels they bundle) for
everything this process has compiled so far, not one function.
``deserialize_compiled`` hands them to
``torch.compiler.load_cache_artifacts``, which fills the local caches,
so the next compile of the same graph hits them: Dynamo still traces,
but Inductor generates no code and Triton compiles nothing. The serving
engine's artifacts are its programs' analysis reports (JSON), since a
captured CUDA graph cannot be serialized.

Artifacts are pickle-based inside torch's format: a cache directory is
TRUSTED INPUT, the same trust level as a checkpoint directory.
"""
from __future__ import annotations

import hashlib
import json
import platform

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "env_fingerprint", "content_key", "abstractify", "signature_str",
    "serialize_compiled", "deserialize_compiled", "code_fingerprint",
    "inductor_config_digest", "AOTUnavailableError",
]

EXEC_FORMAT = "inductor-cache-artifacts-v1"


class AOTUnavailableError(RuntimeError):
    """This process has no compiled artifacts to serialize."""


def inductor_config_digest():
    """Stable digest of Inductor's configuration as it stands: any option
    that changes what Inductor generates (a tuning mode, a backend switch,
    deterministic mode) misses the cache cleanly instead of restoring code
    generated under other options. Values that are not plain data digest
    by their type name (their repr may hold a process-local address)."""
    from torch._inductor import config

    def plain(v):
        return type(v).__name__

    text = json.dumps(config.get_config_copy(), sort_keys=True,
                      default=plain)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _device():
    """``(name, "major.minor")`` of CUDA device 0, or ``("cpu", "")``."""
    if not torch.cuda.is_available():
        return "cpu", ""
    major, minor = torch.cuda.get_device_capability(0)
    return torch.cuda.get_device_name(0), f"{major}.{minor}"


def env_fingerprint():
    """The environment an artifact is only valid under."""
    from ..kernels._build import library_digests

    name, capability = _device()
    kernels = hashlib.sha256(json.dumps(
        library_digests(), sort_keys=True).encode()).hexdigest()[:16]
    return {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "device": name,
        "capability": capability,
        "kernels": kernels,
        "python": platform.python_version(),
        "exec_format": EXEC_FORMAT,
    }


def _env_token(env=None):
    env = env or env_fingerprint()
    return "|".join(f"{k}={env[k]}" for k in sorted(env))


def content_key(name, signature, env=None):
    """Content address for one compiled program: sha256 over the fn
    name, its abstract input signature, and the environment
    fingerprint. Hex-truncated to 32 chars (128 bits — collision-safe
    for any plausible cache population)."""
    h = hashlib.sha256()
    h.update(str(name).encode())
    h.update(b"\x00")
    h.update(str(signature).encode())
    h.update(b"\x00")
    h.update(_env_token(env).encode())
    return h.hexdigest()[:32]


class _Abstract:
    """A tensor's abstract value: shape, dtype and device type."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, t):
        self.shape = tuple(t.shape)
        self.dtype = t.dtype
        self.device = t.device.type

    def __repr__(self):
        return f"{self.shape}:{self.dtype}:{self.device}"


def abstractify(tree):
    """Map a pytree of tensors to their abstract values (shape, dtype,
    device type); other leaves stay."""
    return pytree.tree_map(
        lambda a: _Abstract(a) if isinstance(a, torch.Tensor) else a, tree)


def signature_str(tree):
    """Stable abstract-signature string of a pytree of tensors (or their
    abstract values): treespec + per-leaf shape/dtype. Hash-friendly and
    identical across processes for identical structures."""
    flat, spec = pytree.tree_flatten(tree)
    leaves = ",".join(
        f"{tuple(x.shape)}:{x.dtype}" if hasattr(x, "shape") else repr(x)
        for x in flat
    )
    return f"{spec}|{leaves}"


def code_fingerprint(fn):
    """Stable digest of a python function's bytecode (recursing into
    nested code objects WITHOUT repr()-ing them — reprs embed object
    addresses, which differ across processes). Returns None when the
    callable exposes no code object (builtins, C extensions) — such
    functions are not disk-cacheable.

    Determinism caveat: the digest covers this function's own bytecode,
    not its callees or closure values — edit a helper the cached function
    calls and the stale artifact still hits. Bump the cache directory (or
    remove the artifact) on such refactors; the environment fingerprint
    already catches the common invalidators (torch upgrades, edited
    kernels).
    """
    code = getattr(fn, "__code__", None)
    if code is None:
        code = getattr(getattr(fn, "__func__", None), "__code__", None)
    if code is None:
        return None
    h = hashlib.sha256()

    def feed(c):
        h.update(c.co_code)
        h.update(str(c.co_names).encode())
        h.update(str(c.co_varnames).encode())
        for const in c.co_consts:
            if hasattr(const, "co_code"):
                feed(const)
            elif isinstance(const, frozenset):
                # `x in {...}` literals compile to frozenset constants
                # whose repr order follows PYTHONHASHSEED — hash the
                # sorted elements or the digest differs per process
                h.update(repr(sorted(const, key=repr)).encode())
            else:
                h.update(repr(const).encode())

    h.update(getattr(fn, "__qualname__", str(fn)).encode())
    feed(code)
    return h.hexdigest()[:32]


def serialize_compiled():
    """The Inductor cache artifacts of everything this process has
    compiled, as bytes (``torch.compiler.save_cache_artifacts``). Raises
    :class:`AOTUnavailableError` when there are none."""
    got = torch.compiler.save_cache_artifacts()
    if got is None:
        raise AOTUnavailableError(
            "no Inductor cache artifacts in this process to serialize")
    return got[0]


def deserialize_compiled(data):
    """bytes -> the ``CacheInfo`` of the artifacts
    ``torch.compiler.load_cache_artifacts`` restored into the local
    caches. Any exception here means the blob does not match this
    runtime — the caller treats it as a cache fallback, not an error."""
    info = torch.compiler.load_cache_artifacts(bytes(data))
    if info is None:
        raise AOTUnavailableError("the blob holds no cache artifacts")
    return info
