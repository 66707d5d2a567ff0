"""Checkpoints in the JAX package's on-disk format v2.

Counterpart of ``paddle_tpu/distributed/checkpoint.py`` for one process:
``save_state_dict`` (with ``async_save`` and ``keep_last_k``),
``load_state_dict``, ``load_full``, ``wait_async_save`` and
``CheckpointCorruptError``, writing and reading the same files, so each
package reads a checkpoint the other wrote:

* every save lands in a fresh ``ckpt-<n>/`` subdirectory through a
  temporary directory, fsync and an atomic rename, as ``data.npz`` (the
  arrays) plus ``metadata.json`` (dtype and shape of every entry, the
  python values, the format number and a crc32 of every array);
* the ``latest`` pointer moves only after the written files re-read and
  verify; a load falls back to the previous verified checkpoint when the
  newest is torn or corrupt (counted in
  ``paddle_tpu_checkpoint_load_fallbacks_total``); a top-level
  ``data.npz``/``metadata.json`` view keeps pre-v2 readers working, and
  the pre-v2 layout (files directly under the path) still loads;
* bfloat16 tensors are saved widened to float32 under ``"dtype":
  "bfloat16"`` (npz has no bfloat16) and narrowed back on load, exactly,
  with torch's own bfloat16 (no ``ml_dtypes``);
* the ``ckpt.write`` fault site fires before each file is written.

Tensors are torch tensors: a save copies each to the host; a load gives
CPU tensors (``load_full``) or copies into the target tensors in place
(``load_state_dict``). The JAX package's sharded save (``process_group``
and per-tensor placements) is not ported: ``process_group`` raises, and
a checkpoint saved with placements loads as its global arrays.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import uuid
import zlib

import numpy as np

import torch

from ..observability import metrics as _obs_metrics
from ..resilience import faults

__all__ = [
    "save_state_dict", "load_state_dict", "load_full",
    "wait_async_save", "CheckpointCorruptError",
]

_META_FILE = "metadata.json"
_DATA_FILE = "data.npz"
_LATEST_FILE = "latest"
_CKPT_PREFIX = "ckpt-"
_FORMAT = 2

# serializes the publish step (dir-index allocation + latest update)
# across concurrent async writers
_publish_lock = threading.Lock()


class CheckpointCorruptError(RuntimeError):
    """No verifiable checkpoint could be loaded from the path."""


# always-on pipeline timings: checkpoint cadence is an SLO input — save time bounds how often you can
# checkpoint, verify time is the recovery critical path, and the
# fallback counter should be zero on a healthy fleet
_save_s = _obs_metrics.histogram(
    "paddle_tpu_checkpoint_save_seconds",
    "write+fsync+verify+publish wall clock per checkpoint save",
)
_verify_s = _obs_metrics.histogram(
    "paddle_tpu_checkpoint_verify_seconds",
    "end-to-end checksum verification per checkpoint dir",
)
_rotate_s = _obs_metrics.histogram(
    "paddle_tpu_checkpoint_rotate_seconds",
    "keep_last_k rotation wall clock per publish",
)
_fallbacks = _obs_metrics.counter(
    "paddle_tpu_checkpoint_load_fallbacks_total",
    "loads that skipped a corrupt newest checkpoint",
)


# in-flight async writers: async_save copies device tensors out
# synchronously, then a worker thread does the IO; wait_async_save() is
# the flush barrier
_async_writers: list = []


def wait_async_save():
    """Block until every pending async checkpoint write has finished,
    re-raising the first writer failure."""
    while _async_writers:
        t, err = _async_writers.pop(0)
        t.join()
        if err:
            raise err[0]


def _crc(arr):
    # crc straight off the array's buffer — no tobytes() copy
    return zlib.crc32(np.ascontiguousarray(arr).data) & 0xFFFFFFFF


def _fsync_file(p):
    with open(p, "rb") as f:
        os.fsync(f.fileno())


def _fsync_dir(p):
    fd = os.open(p, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse dir fsync; rename is still atomic
    finally:
        os.close(fd)


def _ckpt_names(path):
    """Versioned checkpoint dirs under ``path``, newest first."""
    try:
        names = [
            n for n in os.listdir(path)
            if n.startswith(_CKPT_PREFIX)
            and n[len(_CKPT_PREFIX):].isdigit()
            and os.path.isdir(os.path.join(path, n))
        ]
    except OSError:
        return []
    return sorted(names, key=lambda n: int(n[len(_CKPT_PREFIX):]),
                  reverse=True)


def _verify_dir(d):
    """Verify one checkpoint dir end to end (json parses, npz opens,
    every checksummed array matches) and return the metadata payload.
    Arrays are verified ONE AT A TIME and dropped — a model-scale
    checkpoint is never fully resident during verification. Raises
    CheckpointCorruptError on any damage so callers can fall back to an
    older checkpoint."""
    import time as _time

    t0 = _time.perf_counter()
    try:
        return _verify_dir_inner(d)
    finally:
        _verify_s.observe(_time.perf_counter() - t0)


def _verify_dir_inner(d):
    try:
        with open(os.path.join(d, _META_FILE)) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"{d}: unreadable metadata ({e})"
        ) from e
    sums = payload.get("checksums")
    try:
        with np.load(os.path.join(d, _DATA_FILE),
                     allow_pickle=False) as data:
            files = set(data.files)
            if sums is not None:
                for key, want in sums.items():
                    if key not in files:
                        raise CheckpointCorruptError(
                            f"{d}: array {key!r} missing from data file"
                        )
                    if _crc(data[key]) != want:
                        raise CheckpointCorruptError(
                            f"{d}: checksum mismatch for {key!r}"
                        )
    except CheckpointCorruptError:
        raise
    except Exception as e:  # BadZipFile / OSError / ValueError / ...
        raise CheckpointCorruptError(f"{d}: unreadable data ({e})") from e
    return payload


class _FileLock:
    """fcntl advisory lock serializing publishers ACROSS processes
    (multi-controller hosts share the checkpoint path); the in-process
    _publish_lock alone cannot order a read-compare-write of ``latest``
    between processes."""

    def __init__(self, path):
        self._path = path
        self._fd = None

    def __enter__(self):
        import fcntl

        self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        except OSError:
            pass  # fs without flock: in-process lock still applies
        return self

    def __exit__(self, *exc):
        import fcntl

        try:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
        except OSError:
            pass
        os.close(self._fd)
        return False


def _publish(path, tmp, keep_last_k):
    """Atomically promote a verified tmp dir: rename to the next
    ``ckpt-<n>``, update ``latest``, refresh the v1 compatibility view,
    rotate old checkpoints. Crash-safe at every boundary — until the
    ``latest`` replace lands, loads keep resolving the previous
    checkpoint."""
    with _publish_lock, _FileLock(os.path.join(path, ".publish.lock")):
        # index allocation races with OTHER processes saving to the same
        # path (multi-controller hosts share it): the rename is the
        # atomic claim, so on collision re-list and take the next index
        for _ in range(64):
            names = _ckpt_names(path)
            n = 1 + (int(names[0][len(_CKPT_PREFIX):]) if names else 0)
            name = f"{_CKPT_PREFIX}{n:08d}"
            final = os.path.join(path, name)
            try:
                os.rename(tmp, final)
                break
            except OSError:
                if not os.path.isdir(final):
                    raise  # not an index collision — surface it
        else:
            raise OSError(
                f"could not claim a checkpoint index under {path}"
            )
        _fsync_dir(path)
        # the latest pointer flips only now, after verification — and
        # only FORWARD: a slow writer in another process must not move
        # it back onto an older checkpoint
        cur = 0
        try:
            with open(os.path.join(path, _LATEST_FILE)) as f:
                c = f.read().strip()
            if c.startswith(_CKPT_PREFIX) and c[len(_CKPT_PREFIX):].isdigit():
                cur = int(c[len(_CKPT_PREFIX):])
        except OSError:
            pass
        if n > cur:
            ltmp = os.path.join(path, f".latest-{uuid.uuid4().hex[:8]}")
            with open(ltmp, "w") as f:
                f.write(name)
                f.flush()
                os.fsync(f.fileno())
            os.replace(ltmp, os.path.join(path, _LATEST_FILE))
            # v1 compatibility view: top-level data.npz/metadata.json
            # track the newest checkpoint. COPIED, not hardlinked — a
            # pre-v2 writer rewriting the top-level files in place
            # (O_TRUNC) must not destroy the versioned data through a
            # shared inode during a mixed-version rollout
            for fname in (_DATA_FILE, _META_FILE):
                vtmp = os.path.join(path, f".view-{uuid.uuid4().hex[:8]}")
                shutil.copy2(os.path.join(final, fname), vtmp)
                _fsync_file(vtmp)  # torn view files defeat its purpose
                os.replace(vtmp, os.path.join(path, fname))
            _fsync_dir(path)
        if keep_last_k:
            import time as _time

            t0 = _time.perf_counter()
            for old in _ckpt_names(path)[keep_last_k:]:
                if old != name:
                    shutil.rmtree(
                        os.path.join(path, old), ignore_errors=True
                    )
            _rotate_s.observe(_time.perf_counter() - t0)


def _host_array(value):
    """A torch tensor -> (its numpy array on the host, the dtype name the
    metadata records): bfloat16 widened to float32 under "bfloat16"."""
    t = value.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy(), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, async_save=False,
                    keep_last_k=None):
    """Write every entry of ``state_dict`` (torch tensors, numpy arrays,
    json-able python values) as checkpoint ``ckpt-<n>`` under ``path``.
    With ``async_save=True`` the copy to the host happens NOW (training
    may overwrite the tensors at once) and the file IO runs on a
    background thread; ``wait_async_save()`` is the flush barrier.

    The save is atomic (temp dir + fsync + rename) and verified (per-array
    crc32 re-read) before the ``latest`` pointer moves; ``keep_last_k``
    bounds how many verified checkpoints are kept (None keeps all)."""
    if process_group is not None:
        raise NotImplementedError(
            "save_state_dict(process_group=...): the sharded, multi-rank "
            "save is not ported; one process saves whole tensors"
        )
    if keep_last_k is not None and keep_last_k < 1:
        raise ValueError(
            f"keep_last_k must be >= 1 or None (keep all), got "
            f"{keep_last_k}"
        )
    os.makedirs(path, exist_ok=True)
    meta = {"tensors": {}}
    arrays = {}
    for key, value in state_dict.items():
        if isinstance(value, torch.Tensor):
            arr, dtype = _host_array(value)
            meta["tensors"][key] = {"dtype": dtype,
                                    "shape": list(arr.shape)}
            arrays[key] = arr
        elif isinstance(value, np.ndarray):
            meta["tensors"][key] = {
                "dtype": str(value.dtype), "shape": list(value.shape),
            }
            arrays[key] = value
        else:
            meta["tensors"][key] = {"python": True}
            arrays[key] = value

    if async_save:
        # snapshot BEFORE the background writer starts: tensors were
        # already copied to the host above, but raw ndarrays and python
        # containers are held by reference, racing user mutation against
        # the writer thread
        import copy as _copy

        arrays = {
            k: (v.copy() if isinstance(v, np.ndarray) else _copy.deepcopy(v))
            for k, v in arrays.items()
        }

    pyvals = {
        k: v for k, v in arrays.items() if not isinstance(v, np.ndarray)
    }
    def _json_default(v):
        # numpy scalars degrade losslessly; anything else is an error —
        # silent str() corruption is worse than failing the save
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, (np.floating, np.bool_)):
            return v.item()
        raise TypeError(
            f"state_dict value of type {type(v).__name__} is not "
            "checkpointable; convert it to a tensor, ndarray, or plain "
            "python value"
        )

    ndarrays = {
        k: v for k, v in arrays.items() if isinstance(v, np.ndarray)
    }

    def _write():
        import time as _time

        t0 = _time.perf_counter()
        # checksums computed HERE so async_save's foreground cost stays
        # the snapshot copy alone (the crc pass rides the writer thread)
        checksums = {k: _crc(v) for k, v in ndarrays.items()}
        tmp = os.path.join(path, f".tmp-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        try:
            faults.fire("ckpt.write", file=_DATA_FILE, path=path)
            np.savez(os.path.join(tmp, _DATA_FILE), **ndarrays)
            faults.fire("ckpt.write", file=_META_FILE, path=path)
            with open(os.path.join(tmp, _META_FILE), "w") as f:
                json.dump(
                    {"meta": meta, "python_values": pyvals,
                     "format": _FORMAT, "checksums": checksums}, f,
                    default=_json_default,
                )
                f.flush()
                os.fsync(f.fileno())
            _fsync_file(os.path.join(tmp, _DATA_FILE))
            _fsync_dir(tmp)
            # verify the bytes that actually hit disk BEFORE publishing:
            # a torn/corrupt write must never become the latest pointer
            _verify_dir(tmp)
            _publish(path, tmp, keep_last_k)
            _save_s.observe(_time.perf_counter() - t0)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    if not async_save:
        _write()
        return

    err: list = []

    def _guarded():
        try:
            _write()
        except Exception as e:  # surfaced at wait_async_save()
            err.append(e)

    t = threading.Thread(target=_guarded, daemon=False)
    t.start()
    _async_writers.append((t, err))


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0):
    """Fill ``state_dict``'s entries from the newest verified checkpoint
    under ``path``: a torch tensor target is copied into in place (shapes
    must match; the value takes the target's dtype and device), any other
    target is replaced by the saved value. Returns (missing keys,
    unexpected keys).

    The ``latest`` pointer is resolved first; if that checkpoint is torn
    or corrupt (checksum mismatch, unreadable file), older verified
    checkpoints are tried newest first before giving up with
    ``CheckpointCorruptError``. ``state_dict`` is only changed after a
    checkpoint fully verifies."""
    if process_group is not None:
        raise NotImplementedError(
            "load_state_dict(process_group=...): the sharded, multi-rank "
            "load is not ported"
        )
    payload, ckpt_dir = _read_checkpoint(path)
    meta = payload["meta"]["tensors"]
    missing, unexpected = [], []
    # lazy handle: arrays decompress one at a time during the copy loop
    with np.load(os.path.join(ckpt_dir, _DATA_FILE),
                 allow_pickle=False) as data:
        for key, target in state_dict.items():
            if key not in meta:
                missing.append(key)
                continue
            info = meta[key]
            if info.get("python"):
                state_dict[key] = payload["python_values"].get(key)
                continue
            src = _decode_array(info, data, key)
            if not isinstance(target, torch.Tensor):
                state_dict[key] = src
                continue
            if list(src.shape) != list(target.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {list(src.shape)} vs "
                    f"target {list(target.shape)}"
                )
            with torch.no_grad():
                target.copy_(src)
    for key in meta:
        if key not in state_dict:
            unexpected.append(key)
    return missing, unexpected


def _decode_array(info, data, key):
    """One saved array entry -> a CPU torch tensor (bfloat16 narrowed back
    from its float32 widening, exactly) -- the single decode point of
    every load."""
    arr = data[key]
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if info.get("dtype") == "bfloat16":
        t = t.to(torch.bfloat16)
    return t


def load_full(path):
    """Load EVERY entry of the newest verified checkpoint under ``path``
    without a target: arrays come back as CPU torch tensors, python
    values as they were saved. The training resume path
    (``resilience.TrainState.load``) needs this: a resuming process
    cannot know ahead of time which keys (mid-accumulation ``grad.*``
    buffers, say) the dying incarnation captured. Same fallback as
    :func:`load_state_dict`."""
    payload, ckpt_dir = _read_checkpoint(path)
    sd = {}
    with np.load(os.path.join(ckpt_dir, _DATA_FILE),
                 allow_pickle=False) as data:
        for key, info in payload["meta"]["tensors"].items():
            if info.get("python"):
                sd[key] = payload["python_values"].get(key)
            else:
                sd[key] = _decode_array(info, data, key)
    return sd


def _read_checkpoint(path):
    """Resolve + verify a checkpoint under ``path``: the v2 ``latest``
    chain with fallback, or the legacy v1 top-level files. Returns
    (metadata payload, directory holding the verified data file)."""
    candidates = _ckpt_names(path)
    latest = None
    try:
        with open(os.path.join(path, _LATEST_FILE)) as f:
            latest = f.read().strip()
    except OSError:
        pass
    if latest and latest in candidates:
        candidates.remove(latest)
        candidates.insert(0, latest)
    if not candidates:
        # legacy (pre-v2) layout: files directly under path. A missing
        # checkpoint keeps raising FileNotFoundError (the long-standing
        # "no checkpoint yet" probe), not CheckpointCorruptError.
        if not os.path.exists(os.path.join(path, _META_FILE)):
            raise FileNotFoundError(f"no checkpoint found under {path}")
        return _verify_dir(path), path
    errors = []
    for name in candidates:
        d = os.path.join(path, name)
        try:
            payload = _verify_dir(d)
        except CheckpointCorruptError as e:
            errors.append(str(e))
            continue
        if errors:
            _fallbacks.inc()
            from ..observability import flight

            flight.record(
                "checkpoint", "fallback", loaded=name,
                skipped="; ".join(errors),
            )
            sys.stderr.write(
                "[checkpoint] fell back to %s after: %s\n"
                % (name, "; ".join(errors))
            )
        return payload, d
    raise CheckpointCorruptError(
        f"no verifiable checkpoint under {path}: " + "; ".join(errors)
    )
