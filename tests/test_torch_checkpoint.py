"""The port's checkpoints (format v2) against the JAX package's, on the
CPU.

The two packages share the on-disk format, so each reads what the other
wrote: key by key, array by array, bit for bit (bfloat16 saved widened
to float32 and narrowed back exactly), python values equal. Also: the
atomic ``ckpt-<n>`` layout with ``latest`` and ``keep_last_k``, the
fallback past a torn or corrupt newest checkpoint (counted), the pre-v2
layout, the ``ckpt.write`` fault site, ``async_save`` snapshots and
``load_state_dict`` into targets.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jax_ckpt
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.resilience import FaultSpec, faults

PY = {"lr": 0.1, "steps": [1, 2, 3], "name": "ckpt", "none": None,
      "flag": True, "nested": {"a": [1.5, -2.25], "b": "x"}}


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "w32": rng.randn(3, 5).astype(np.float32),
        "wbf": rng.randn(4, 2).astype(np.float32),     # saved as bf16
        "w16": rng.randn(6).astype(np.float16),
        "ids": rng.randint(0, 100, (2, 3)).astype(np.int32),   # JAX: no x64
        "mask": rng.rand(5) > 0.5,
        "keys": rng.randint(0, 2 ** 32 - 1, 7).astype(np.uint32),
    }


def _port_state(seed=0):
    a = _arrays(seed)
    return {
        "model.w32": torch.from_numpy(a["w32"]),
        "model.wbf": torch.from_numpy(a["wbf"]).to(torch.bfloat16),
        "model.w16": torch.from_numpy(a["w16"]),
        "data.ids": torch.from_numpy(a["ids"]),
        "mask": torch.from_numpy(a["mask"]),
        "rng.np.keys": a["keys"],
        "train.step": 7,
        "opt.LR_Scheduler": PY,
    }


def _jax_state(seed=0):
    a = _arrays(seed)
    return {
        "model.w32": paddle.to_tensor(a["w32"]),
        "model.wbf": paddle.to_tensor(a["wbf"]).astype("bfloat16"),
        "model.w16": paddle.to_tensor(a["w16"]),
        "data.ids": paddle.to_tensor(a["ids"]),
        "mask": paddle.to_tensor(a["mask"]),
        "rng.np.keys": a["keys"],
        "train.step": 7,
        "opt.LR_Scheduler": PY,
    }


def _bits(v):
    """A value's exact content: (dtype name, shape, raw bytes) for arrays
    (bfloat16 as its 16-bit words), the value itself otherwise."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return ("bfloat16", tuple(v.shape),
                    v.view(torch.int16).numpy().tobytes())
        return (str(v.numpy().dtype), tuple(v.shape), v.numpy().tobytes())
    if hasattr(v, "_data"):                       # a JAX package Tensor
        arr = np.asarray(v._data)
        if arr.dtype.name == "bfloat16":
            return ("bfloat16", arr.shape, arr.view(np.int16).tobytes())
        return (str(arr.dtype), arr.shape, arr.tobytes())
    if isinstance(v, np.ndarray):
        return (str(v.dtype), v.shape, v.tobytes())
    return v


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


def test_port_round_trip_bit_exact(tmp_path):
    sd = _port_state()
    ckpt.save_state_dict(sd, str(tmp_path))
    got = ckpt.load_full(str(tmp_path))
    want = dict(sd, **{"rng.np.keys": torch.from_numpy(sd["rng.np.keys"])})
    _assert_same(got, want)
    assert got["model.wbf"].dtype == torch.bfloat16
    meta = json.load(open(tmp_path / "ckpt-00000001" / "metadata.json"))
    assert meta["format"] == 2
    assert meta["meta"]["tensors"]["model.wbf"]["dtype"] == "bfloat16"
    assert set(meta["checksums"]) == {k for k, v in sd.items()
                                      if not isinstance(v, (int, dict))}


def test_jax_checkpoint_read_by_the_port(tmp_path):
    jax_ckpt.save_state_dict(_jax_state(), str(tmp_path), keep_last_k=2)
    got = ckpt.load_full(str(tmp_path))
    _assert_same(got, _jax_state())
    assert got["model.wbf"].dtype == torch.bfloat16
    assert got["train.step"] == 7 and got["opt.LR_Scheduler"] == PY


def test_port_checkpoint_read_by_jax(tmp_path):
    ckpt.save_state_dict(_port_state(), str(tmp_path), keep_last_k=2)
    got = jax_ckpt.load_full(str(tmp_path))
    _assert_same(got, _port_state())
    assert got["model.wbf"].dtype.name == "bfloat16"


def test_versions_latest_and_keep_last_k(tmp_path):
    path = str(tmp_path)
    for i in range(4):
        ckpt.save_state_dict({"x": torch.tensor([float(i)])}, path,
                             keep_last_k=2)
    names = sorted(n for n in os.listdir(path) if n.startswith("ckpt-"))
    assert names == ["ckpt-00000003", "ckpt-00000004"]
    assert open(os.path.join(path, "latest")).read() == "ckpt-00000004"
    # the v1 view tracks the newest checkpoint
    assert os.path.exists(os.path.join(path, "data.npz"))
    assert ckpt.load_full(path)["x"].item() == 3.0
    with pytest.raises(ValueError, match="keep_last_k"):
        ckpt.save_state_dict({}, path, keep_last_k=0)
    with pytest.raises(NotImplementedError, match="process_group"):
        ckpt.save_state_dict({}, path, process_group=object())


def _fallbacks():
    return ckpt._fallbacks.value


@pytest.mark.parametrize("damage", ["torn_data", "flipped_bytes",
                                    "bad_metadata", "missing_data"])
def test_damaged_newest_falls_back_to_previous(tmp_path, damage):
    path = str(tmp_path)
    ckpt.save_state_dict({"x": torch.arange(1000.0)}, path)
    ckpt.save_state_dict({"x": torch.arange(1000.0) + 1}, path)
    newest = tmp_path / "ckpt-00000002"
    data = newest / "data.npz"
    if damage == "torn_data":
        raw = data.read_bytes()
        data.write_bytes(raw[:len(raw) // 2])
    elif damage == "flipped_bytes":
        raw = bytearray(data.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        data.write_bytes(bytes(raw))
    elif damage == "bad_metadata":
        (newest / "metadata.json").write_text("{not json")
    else:
        data.unlink()
    before = _fallbacks()
    got = ckpt.load_full(path)
    assert torch.equal(got["x"], torch.arange(1000.0))
    assert _fallbacks() == before + 1
    # the JAX package falls back the same way on the port's files
    assert np.array_equal(jax_ckpt.load_full(path)["x"].numpy(),
                          np.arange(1000.0, dtype=np.float32))


def test_nothing_verifiable_raises(tmp_path):
    path = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.load_full(path)
    ckpt.save_state_dict({"x": torch.zeros(3)}, path)
    (tmp_path / "ckpt-00000001" / "data.npz").write_bytes(b"junk")
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_full(path)


def test_v1_layout_still_loads(tmp_path):
    """Pre-v2 checkpoints hold data.npz and metadata.json directly under
    the path: the port reads them, the JAX package's and its own."""
    for writer, state, name in ((jax_ckpt, _jax_state(), "jax"),
                                (ckpt, _port_state(), "port")):
        path = tmp_path / name
        writer.save_state_dict(state, str(path))
        for entry in os.listdir(path):
            if entry.startswith("ckpt-"):
                shutil.rmtree(path / entry)
            elif entry == "latest":
                (path / entry).unlink()
        assert sorted(p for p in os.listdir(path)
                      if not p.startswith(".")) == ["data.npz",
                                                    "metadata.json"]
        _assert_same(ckpt.load_full(str(path)), _jax_state())


def test_ckpt_write_fault_leaves_latest_alone(tmp_path):
    path = str(tmp_path)
    ckpt.save_state_dict({"x": torch.zeros(2)}, path)
    for file in ("data.npz", "metadata.json"):
        spec = FaultSpec(OSError("disk full"),
                         when=lambda ctx, f=file: ctx["file"] == f)
        with faults.inject({"ckpt.write": spec}) as inj:
            with pytest.raises(OSError, match="disk full"):
                ckpt.save_state_dict({"x": torch.ones(2)}, path)
        assert inj.fired["ckpt.write"] == 1
        assert not [n for n in os.listdir(path) if n.startswith(".tmp-")]
        assert open(os.path.join(path, "latest")).read() == "ckpt-00000001"
        assert torch.equal(ckpt.load_full(path)["x"], torch.zeros(2))


def test_async_save_snapshots_at_the_call(tmp_path):
    path = str(tmp_path)
    x = torch.arange(6.0)
    arr = np.arange(3)
    py = {"k": [1]}
    ckpt.save_state_dict({"x": x, "arr": arr, "py": py}, path,
                         async_save=True)
    x.add_(100)
    arr += 100
    py["k"].append(2)
    ckpt.wait_async_save()
    got = ckpt.load_full(path)
    assert torch.equal(got["x"], torch.arange(6.0))
    assert got["arr"].tolist() == [0, 1, 2] and got["py"] == {"k": [1]}


def test_async_save_error_surfaces_at_wait(tmp_path):
    with faults.inject({"ckpt.write": FaultSpec(OSError("boom"))}):
        ckpt.save_state_dict({"x": torch.zeros(1)}, str(tmp_path),
                             async_save=True)
        with pytest.raises(OSError, match="boom"):
            ckpt.wait_async_save()


def test_load_state_dict_into_targets(tmp_path):
    path = str(tmp_path)
    ckpt.save_state_dict(_port_state(), path)
    target = {"model.w32": torch.zeros(3, 5),
              "model.wbf": torch.zeros(4, 2, dtype=torch.bfloat16),
              "train.step": None, "absent": torch.zeros(1)}
    w32 = target["model.w32"]
    missing, unexpected = ckpt.load_state_dict(target, path)
    assert missing == ["absent"]
    assert set(unexpected) == set(_port_state()) - set(target)
    assert target["model.w32"] is w32 and torch.equal(
        w32, _port_state()["model.w32"])
    assert _bits(target["model.wbf"]) == _bits(_port_state()["model.wbf"])
    assert target["train.step"] == 7
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_state_dict({"model.w32": torch.zeros(5, 3)}, path)


def test_unsupported_value_fails_the_save(tmp_path):
    with pytest.raises(TypeError, match="not checkpointable"):
        ckpt.save_state_dict({"bad": {"o": object()}}, str(tmp_path))
    assert not [n for n in os.listdir(tmp_path) if n.startswith("ckpt-")]
