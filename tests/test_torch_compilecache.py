"""paddle_tpu_torch.compilecache against the JAX package's on the CPU.

* The store, keys and manifest are the JAX ones' (copied): every case of
  JAX's ``TestArtifactStore``/``TestKeysAndManifest``/``TestCacheAccounting``
  runs against the port, and what the port writes the JAX package reads
  (the same content keys, code fingerprints, artifact and manifest
  formats).
* The serving engine with ``EngineConfig(compile_cache=)`` and the gates
  on (``analysis_check="error"`` and a memory budget): a warm build runs
  the analyzer's trace 0 times (the trace monkeypatched to raise), logs
  one ``aot-hit`` per program, captures the whole program family before
  the first request and none while serving, and its greedy tokens equal
  the cold engine's and JAX ``generate``'s, for ``LlamaConfig.tiny()``
  and its GQA variant. The enlarged family (prefix cache, chunked
  prefill, speculation) is listed in the manifest and replayed.
* Every damaged artifact (a flipped bit, a truncated blob, a stale
  environment, an injected ``cc.load`` or ``cc.write`` fault) degrades to
  a counted, warned miss that costs that program one trace.
* A fleet's rolling restart builds warm; the ``warm`` CLI; the collector
  view and the ``dump`` render.
"""
import json
import os
import shutil
import sys
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import compilecache as jax_cc
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import compilecache
from paddle_tpu_torch.analysis import trace as analysis_trace
from paddle_tpu_torch.compilecache import (
    ArtifactStore,
    CacheCorruptError,
    CompileCache,
    WarmupManifest,
)
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.observability import jit_events
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.faults import FaultSpec
from paddle_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Fleet,
    FleetConfig,
    SamplingParams,
)

PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12]]
MAX_NEW = 6


# ------------------------------------------------------------- the store --
@pytest.fixture(params=["port", "jax"])
def store_cls(request):
    """The store cases run against both packages: the port's copy must
    behave as JAX's does."""
    return (ArtifactStore if request.param == "port"
            else jax_cc.ArtifactStore), (
        CacheCorruptError if request.param == "port"
        else jax_cc.CacheCorruptError)


class TestArtifactStore:
    def test_put_get_roundtrip(self, tmp_path, store_cls):
        cls, _ = store_cls
        st = cls(str(tmp_path))
        st.put("k1", {"exec": b"payload"}, {"name": "f"})
        meta, blobs = st.get("k1")
        assert blobs == {"exec": b"payload"}
        assert meta["name"] == "f"
        assert "exec" in meta["checksums"]
        assert st.get("absent") is None

    def test_bit_flip_raises_corrupt(self, tmp_path, store_cls):
        cls, corrupt = store_cls
        st = cls(str(tmp_path))
        st.put("k1", {"exec": b"x" * 64}, {})
        p = tmp_path / "objects" / "k1" / "exec.bin"
        raw = bytearray(p.read_bytes())
        raw[10] ^= 0xFF
        p.write_bytes(bytes(raw))
        with pytest.raises(corrupt, match="checksum"):
            st.get("k1")

    def test_truncated_blob_raises_corrupt(self, tmp_path, store_cls):
        cls, corrupt = store_cls
        st = cls(str(tmp_path))
        st.put("k1", {"exec": b"x" * 64}, {})
        p = tmp_path / "objects" / "k1" / "exec.bin"
        p.write_bytes(p.read_bytes()[:32])
        with pytest.raises(corrupt, match="checksum"):
            st.get("k1")

    def test_unreadable_meta_raises_corrupt(self, tmp_path, store_cls):
        cls, corrupt = store_cls
        st = cls(str(tmp_path))
        st.put("k1", {"exec": b"x"}, {})
        (tmp_path / "objects" / "k1" / "meta.json").write_text("{oops")
        with pytest.raises(corrupt, match="metadata"):
            st.get("k1")

    def test_failed_put_leaves_previous_state(self, tmp_path, store_cls):
        cls, _ = store_cls
        st = cls(str(tmp_path))
        st.put("k1", {"exec": b"old"}, {})
        with pytest.raises(TypeError):
            st.put("k1", {"exec": "not-bytes"}, {})
        _, blobs = st.get("k1")
        assert blobs["exec"] == b"old"
        assert not [n for n in os.listdir(tmp_path)
                    if n.startswith(".tmp-")]

    def test_keep_last_k_eviction(self, tmp_path, store_cls):
        cls, _ = store_cls
        st = cls(str(tmp_path), keep_last_k=2)
        for i in range(4):
            st.put(f"k{i}", {"b": bytes([i])}, {})
            os.utime(st._dir(f"k{i}"), (i, i))
        st.put("k9", {"b": b"z"}, {})
        keys = set(st.keys())
        assert "k9" in keys and len(keys) == 2

    def test_invalid_keys_rejected(self, tmp_path, store_cls):
        cls, _ = store_cls
        st = cls(str(tmp_path))
        for bad in ("", "a/b", ".hidden"):
            with pytest.raises(ValueError):
                st.put(bad, {"b": b""}, {})
        with pytest.raises(ValueError):
            cls(str(tmp_path), keep_last_k=0)

    def test_same_key_republish_is_atomic_and_clean(self, tmp_path,
                                                    store_cls):
        cls, _ = store_cls
        st = cls(str(tmp_path))
        st.put("k1", {"exec": b"old"}, {"gen": 1})
        st.put("k1", {"exec": b"new"}, {"gen": 2})
        meta, blobs = st.get("k1")
        assert blobs["exec"] == b"new" and meta["gen"] == 2
        assert not [n for n in os.listdir(tmp_path)
                    if n.startswith((".tmp-", ".old-"))]

    def test_failed_republish_restores_previous_artifact(
            self, tmp_path, monkeypatch, store_cls):
        cls, _ = store_cls
        st = cls(str(tmp_path))
        st.put("k1", {"exec": b"old"}, {"gen": 1})
        final = st._dir("k1")
        real_rename = os.rename

        def flaky(src, dst):
            if dst == final and ".tmp-" in src:
                raise OSError(13, "injected rename failure")
            return real_rename(src, dst)

        monkeypatch.setattr(os, "rename", flaky)
        with pytest.raises(OSError, match="injected rename"):
            st.put("k1", {"exec": b"new"}, {"gen": 2})
        monkeypatch.undo()
        meta, blobs = st.get("k1")
        assert blobs["exec"] == b"old" and meta["gen"] == 1
        assert not [n for n in os.listdir(tmp_path)
                    if n.startswith((".tmp-", ".old-"))]

    def test_stale_staging_dirs_swept_on_init(self, tmp_path, store_cls):
        cls, _ = store_cls
        for name, age_s in ((".tmp-dead", 7200), (".old-dead", 7200),
                            (".tmp-live", 10)):
            d = tmp_path / name
            d.mkdir()
            t = time.time() - age_s
            os.utime(d, (t, t))
        cls(str(tmp_path))
        left = {n for n in os.listdir(tmp_path)
                if n.startswith((".tmp-", ".old-"))}
        assert left == {".tmp-live"}

    def test_jax_reads_what_the_port_writes(self, tmp_path):
        ArtifactStore(str(tmp_path)).put("k1", {"exec": b"abc"}, {"n": 1})
        meta, blobs = jax_cc.ArtifactStore(str(tmp_path)).get("k1")
        assert blobs == {"exec": b"abc"} and meta["n"] == 1


# ------------------------------------------------------ keys and manifest --
def _mk(two):
    if two:
        def f(x):
            return x + 2
    else:
        def f(x):
            return x + 1
    return f


class TestKeysAndManifest:
    def test_content_key_env_sensitivity_and_jax_parity(self):
        env = compilecache.env_fingerprint()
        k1 = compilecache.content_key("f", "sig", env)
        assert k1 == compilecache.content_key("f", "sig", env)
        assert k1 != compilecache.content_key("g", "sig", env)
        assert k1 != compilecache.content_key("f", "sig2", env)
        assert k1 != compilecache.content_key("f", "sig", dict(
            env, torch="0.0.1"))
        # the same address as JAX's for the same (name, sig, env)
        assert k1 == jax_cc.content_key("f", "sig", env)

    def test_env_names_the_torch_runtime_and_the_kernels(self):
        env = compilecache.env_fingerprint()
        assert env["torch"] == torch.__version__
        assert env["device"] == ("cpu" if not torch.cuda.is_available()
                                 else torch.cuda.get_device_name(0))
        assert len(env["kernels"]) == 16
        assert compilecache.env_fingerprint() == env   # stable

    def test_inductor_option_flip_rekeys_to_static(self, tmp_path,
                                                   monkeypatch):
        """Inductor's configuration keys a to_static artifact (read at the
        call, as JAX's XLA_FLAGS digest), not the cache's environment: an
        engine's analysis reports do not depend on it."""
        from torch._inductor import config

        from paddle_tpu_torch import jit

        staged = jit.to_static(_mk(False), cache=str(tmp_path),
                               backend="aot_eager")
        call = (("spec",), "()"), [torch.ones(2)]
        before = staged._cache_key(*call)
        monkeypatch.setattr(config, "max_autotune", not config.max_autotune)
        after = staged._cache_key(*call)
        assert before[2] != after[2] and ":inductor=" in before[1]
        assert "inductor" not in compilecache.env_fingerprint()

    def test_code_fingerprint_tracks_bytecode_as_jax_does(self):
        fp = compilecache.code_fingerprint
        assert fp(_mk(False)) == fp(_mk(False))
        assert fp(_mk(False)) != fp(_mk(True))
        assert fp(len) is None
        assert fp(_mk(True)) == jax_cc.code_fingerprint(_mk(True))

    def test_frozenset_const_fingerprint_order_insensitive(self):
        def base(x):
            return x in {1, 9}

        code = base.__code__

        def with_set(fs):
            consts = tuple(fs if isinstance(c, frozenset) else c
                           for c in code.co_consts)
            return types.FunctionType(code.replace(co_consts=consts), {},
                                      "base")

        a, b = frozenset([1, 9]), frozenset([9, 1])
        assert list(a) != list(b)
        assert compilecache.code_fingerprint(with_set(a)) == \
            compilecache.code_fingerprint(with_set(b))

    def test_signature_str_is_stable_and_shape_sensitive(self):
        a = {"w": torch.zeros(2, 3), "n": 4}
        s = compilecache.signature_str(compilecache.abstractify(a))
        assert s == compilecache.signature_str(a)
        assert "(2, 3):torch.float32" in s
        assert s != compilecache.signature_str({"w": torch.zeros(3, 2),
                                                "n": 4})

    def test_manifest_roundtrip_read_by_jax(self, tmp_path):
        m = WarmupManifest(str(tmp_path), "svc")
        m.add("f", "sig", "key1", kind="decode")
        m.add("f", "sig", "key1", kind="decode")      # idempotent
        m.add("g", "sig2", "key2", kind="prefill", bucket=32)
        m.save()
        assert WarmupManifest(str(tmp_path), "svc").load() == m.entries
        assert jax_cc.WarmupManifest(str(tmp_path), "svc").load() == \
            m.entries
        assert len(m.entries) == 2

    def test_resolve_memoizes_and_rebinds_keep_last_k(self, tmp_path):
        p = str(tmp_path / "cc")
        c1 = compilecache.resolve(p)
        assert compilecache.resolve(p) is c1
        assert c1.store.keep_last_k is None
        c2 = compilecache.resolve(p, keep_last_k=2)
        assert c2 is c1 and c1.store.keep_last_k == 2

    def test_manifest_damage_degrades_to_empty(self, tmp_path):
        m = WarmupManifest(str(tmp_path), "svc")
        assert m.load() == []
        os.makedirs(tmp_path / "manifests", exist_ok=True)
        (tmp_path / "manifests" / "svc.json").write_text("{torn")
        assert m.load() == []


class TestCacheAccounting:
    """A fetched-but-unusable artifact is one fallback, never a hit."""

    def test_unloadable_blob_is_fallback_not_hit(self, tmp_path, capsys):
        cc = CompileCache(str(tmp_path))
        key = cc.key("f", "sig")
        cc.store.put(key, {"exec": b"not-cache-artifacts"},
                     {"name": "f", "env": cc.env})
        hits0 = jit_events.aot_hits()
        assert cc.load_executable(key, name="f") is None
        snap = cc.metrics.snapshot()
        assert snap["hits"] == 0 and snap["fallbacks"] == 1
        assert jit_events.aot_hits() == hits0
        assert "artifact unusable" in capsys.readouterr().err
        assert not cc.store.contains(key)

    def test_sidecar_failure_is_fallback_not_hit(self, tmp_path, capsys):
        cc = CompileCache(str(tmp_path))
        key = cc.key("g", "sig")
        assert cc.store_artifact(key, {"analysis": b"torn-sidecar"},
                                 name="g")
        hits0 = jit_events.aot_hits()
        got = cc.load_artifact(
            key, name="g",
            finish=lambda meta, blobs: json.loads(blobs["analysis"]))
        assert got is None
        snap = cc.metrics.snapshot()
        assert snap["hits"] == 0 and snap["fallbacks"] == 1
        assert jit_events.aot_hits() == hits0
        assert not cc.store.contains(key)
        # a healthy artifact hits, exactly once, finish applied
        key2 = cc.key("g2", "sig")
        cc.store_artifact(key2, {"analysis": b'{"a": 1}'}, name="g2")
        got = cc.load_artifact(
            key2, name="g2",
            finish=lambda meta, blobs: json.loads(blobs["analysis"]))
        assert got == {"a": 1} and cc.metrics.hits == 1
        assert jit_events.aot_hits() == hits0 + 1
        assert cc.metrics.bytes_written == len(b"torn-sidecar{\"a\": 1}")

    def test_nothing_compiled_is_a_store_error(self, tmp_path, capsys,
                                               monkeypatch):
        monkeypatch.setattr(torch.compiler, "save_cache_artifacts",
                            lambda: None)
        cc = CompileCache(str(tmp_path))
        assert cc.store_executable(cc.key("h", "sig"), name="h") is False
        assert cc.metrics.store_errors == 1
        assert "failed to serialize" in capsys.readouterr().err


# ---------------------------------------------------------------- engine --
GATES = dict(analysis_check="error", device_memory_budget=1 << 30)
VARIANTS = {"mha": {}, "gqa": {"num_key_value_heads": 2}}


def _engine_config(root, **kw):
    base = dict(max_batch_slots=2, max_model_len=32, page_size=4,
                prefill_buckets=[32], compile_cache=str(root), **GATES)
    base.update(kw)
    return EngineConfig(**base)


def _tokens(engine):
    outs = engine.generate(PROMPTS, SamplingParams(max_new_tokens=MAX_NEW))
    return [tuple(o.token_ids) for o in outs]


def _compiles(engine):
    m = engine.metrics
    return (m.decode_compiles, m.prefill_compiles, m.prefill_ext_compiles,
            m.cow_compiles, m.verify_compiles)


def _pair(variant):
    over = VARIANTS[variant]
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny(**over))
    state = {k: v.numpy() for k, v in jax_model.state_dict().items()}
    port = LlamaForCausalLM(LlamaConfig.tiny(**over), device="cpu")
    load_reference_state(port, state)
    return jax_model, port


def _cold(model, root, **kw):
    """One cold gated build + run: ``(tokens, engine)``."""
    n0 = analysis_trace.trace_count()
    eng = Engine(model, _engine_config(root, **kw))
    assert analysis_trace.trace_count() > n0       # the cold build traced
    return _tokens(eng), eng


@pytest.fixture(scope="module")
def pair():
    return _pair("mha")


@pytest.fixture(scope="module")
def warm_cache(pair, tmp_path_factory):
    """The cache every warm and damage test copies from."""
    root = tmp_path_factory.mktemp("cc")
    cold, eng = _cold(pair[1], root)
    # the whole family captured at build: greedy and sampling decode, the
    # one prefill bucket
    assert _compiles(eng) == (2, 1, 0, 0, 0)
    return str(root), cold


def no_trace(monkeypatch):
    """The analyzer's trace raises from here on: a warm build must not
    reach it."""
    def boom(*a, **k):
        raise AssertionError("the analyzer traced on a warm build")

    from paddle_tpu_torch.analysis import api

    monkeypatch.setattr(analysis_trace, "trace", boom)
    monkeypatch.setattr(api, "trace", boom)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_warm_gated_build_traces_nothing_and_matches_cold_and_jax(
        variant, tmp_path, monkeypatch):
    jax_model, model = _pair(variant)
    root = str(tmp_path / "cc")
    cold, _ = _cold(model, root)
    no_trace(monkeypatch)
    hits0 = jit_events.aot_hits()
    eng = Engine(model, _engine_config(root))
    assert jit_events.aot_hits() == hits0 + 3           # one per program
    assert _compiles(eng) == (2, 1, 0, 0, 0)            # before traffic
    assert eng.metrics.program_bytes.get("decode", 0) > 0
    assert _tokens(eng) == cold
    assert _compiles(eng) == (2, 1, 0, 0, 0)            # none serving
    want = [tuple(jax_model.generate(
        paddle.to_tensor(np.array([p], dtype="int64")),
        max_new_tokens=MAX_NEW).numpy()[0, len(p):].tolist())
        for p in PROMPTS]
    assert cold == want
    # the gates re-evaluate over the stored reports: a budget below the
    # stored peaks still refuses the config, with no trace
    with pytest.raises(Exception, match="budget"):
        Engine(model, _engine_config(root, device_memory_budget=1024))


def test_manifest_lists_program_set(warm_cache):
    root, _ = warm_cache
    mdir = os.path.join(root, "manifests")
    (mname,) = os.listdir(mdir)
    with open(os.path.join(mdir, mname)) as f:
        entries = json.load(f)["entries"]
    assert sorted((e["kind"], e["bucket"], e["any_sample"])
                  for e in entries) == [("decode", None, False),
                                        ("decode", None, True),
                                        ("prefill", 32, False)]
    store = ArtifactStore(root)
    for e in entries:
        assert store.contains(e["store_key"]) and e["memory"] > 0
        # the key embeds the adapter's code identity and the kernels
        assert "code=LlamaServingAdapter|" in e["signature"]
        assert "kernels=flash_attention=" in e["signature"]


def test_aot_hits_are_not_retraces(pair, warm_cache):
    _, model = pair
    before = jit_events.retraces_after_warmup()
    Engine(model, _engine_config(warm_cache[0]))
    log = [e for e in jit_events.compile_log() if e["kind"] == "aot-hit"]
    assert log and all(not e["retrace"] for e in log)
    # the captures of a second engine are fresh captures, not retraces
    assert jit_events.retraces_after_warmup() == before


def _damaged_copy(src, tmp_path, mutate):
    """Copy the cache and apply ``mutate(objects_dir, entry)`` to the
    greedy decode program's artifact."""
    dst = str(tmp_path / "cache")
    shutil.copytree(src, dst)
    mdir = os.path.join(dst, "manifests")
    (mname,) = os.listdir(mdir)
    with open(os.path.join(mdir, mname)) as f:
        entries = json.load(f)["entries"]
    (decode,) = [e for e in entries
                 if e["kind"] == "decode" and not e["any_sample"]]
    mutate(os.path.join(dst, "objects"), decode)
    return dst


def _flip(objects, entry):
    p = os.path.join(objects, entry["store_key"], "analysis.bin")
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(p, "wb").write(bytes(raw))


def _truncate(objects, entry):
    p = os.path.join(objects, entry["store_key"], "analysis.bin")
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[: len(raw) // 2])


def _stale(objects, entry):
    p = os.path.join(objects, entry["store_key"], "meta.json")
    meta = json.load(open(p))
    meta["env"]["torch"] = "0.0.1"
    json.dump(meta, open(p, "w"))


@pytest.mark.parametrize("mutate,msg", [
    (_flip, "checksum mismatch"), (_truncate, "checksum mismatch"),
    (_stale, "environment mismatch")], ids=["bit_flip", "truncated",
                                             "stale_version"])
def test_damaged_artifact_falls_back(pair, warm_cache, tmp_path, capsys,
                                     mutate, msg):
    _, model = pair
    root, cold = warm_cache
    dst = _damaged_copy(root, tmp_path, mutate)
    cc = compilecache.resolve(dst)
    f0 = cc.metrics.fallbacks
    n0 = analysis_trace.trace_count()
    eng = Engine(model, _engine_config(dst))
    assert cc.metrics.fallbacks == f0 + 1
    assert analysis_trace.trace_count() == n0 + 1   # that program alone
    assert msg in capsys.readouterr().err
    assert _tokens(eng) == cold
    # the damaged artifact was re-published: the next build is warm
    n0 = analysis_trace.trace_count()
    Engine(model, _engine_config(dst))
    assert analysis_trace.trace_count() == n0
    assert cc.metrics.store_errors == 0


def test_injected_load_fault_falls_back(pair, warm_cache, tmp_path, capsys):
    _, model = pair
    root, cold = warm_cache
    dst = str(tmp_path / "cache")
    shutil.copytree(root, dst)
    cc = compilecache.resolve(dst)
    f0 = cc.metrics.fallbacks
    n0 = analysis_trace.trace_count()
    with faults.inject({"cc.load": FaultSpec(
            OSError("injected read error"), every=1, max_fires=1)}) as inj:
        eng = Engine(model, _engine_config(dst))
    assert inj.fired["cc.load"] == 1
    assert cc.metrics.fallbacks == f0 + 1
    assert analysis_trace.trace_count() == n0 + 1
    assert "injected read error" in capsys.readouterr().err
    assert _tokens(eng) == cold


def test_injected_write_fault_degrades_to_cold_cache(pair, tmp_path,
                                                     capsys):
    _, model = pair
    root = str(tmp_path / "cache")
    with faults.inject({"cc.write": FaultSpec(
            OSError(28, "No space left on device"), every=1)}) as inj:
        eng = Engine(model, _engine_config(root))
    assert inj.fired["cc.write"] == 3
    assert compilecache.resolve(root).metrics.store_errors == 3
    assert "failed to persist" in capsys.readouterr().err
    assert ArtifactStore(root).keys() == []
    assert not [n for n in os.listdir(root) if n.startswith(".tmp-")]
    assert _compiles(eng) == (2, 1, 0, 0, 0)


PFX_CFG = dict(prefill_buckets=[8, 32], enable_prefix_cache=True,
               prefill_chunk_tokens=8, speculate_tokens=2)


@pytest.fixture(scope="module")
def warm_pfx_cache(pair, tmp_path_factory):
    """One cold build of the enlarged family: prefill and prefill_ext per
    bucket, both decodes, copy-on-write, verify."""
    _, model = pair
    root = tmp_path_factory.mktemp("ccpfx")
    eng = Engine(model, _engine_config(root, **PFX_CFG))
    assert _compiles(eng) == (2, 2, 2, 1, 1)
    return str(root), _tokens(eng)


def test_manifest_covers_enlarged_program_set(warm_pfx_cache):
    root, _ = warm_pfx_cache
    mdir = os.path.join(root, "manifests")
    (mname,) = os.listdir(mdir)
    with open(os.path.join(mdir, mname)) as f:
        entries = json.load(f)["entries"]
    assert sorted({e["kind"] for e in entries}) == [
        "cow", "decode", "prefill", "prefill_ext", "verify"]
    assert sorted(e["bucket"] for e in entries
                  if e["kind"] == "prefill_ext") == [8, 32]
    store = ArtifactStore(root)
    assert len(entries) == 8
    assert all(store.contains(e["store_key"]) for e in entries)


def test_warm_restart_replays_enlarged_set(pair, warm_pfx_cache,
                                           monkeypatch):
    _, model = pair
    no_trace(monkeypatch)
    root, cold = warm_pfx_cache
    hits0 = jit_events.aot_hits()
    eng = Engine(model, _engine_config(root, **PFX_CFG))
    assert jit_events.aot_hits() == hits0 + 8
    assert _compiles(eng) == (2, 2, 2, 1, 1)
    assert _tokens(eng) == cold
    assert _tokens(eng) == cold          # second pass: prefix-cache hits
    assert eng.metrics.prefix_hit_tokens > 0
    assert _compiles(eng) == (2, 2, 2, 1, 1)


def test_fleet_rolling_restart_replays_manifest(pair, warm_cache,
                                               monkeypatch):
    _, model = pair
    no_trace(monkeypatch)
    root, cold = warm_cache
    hits0 = jit_events.aot_hits()
    fleet = Fleet(model, _engine_config(root),
                  FleetConfig(num_replicas=2, max_restarts=1))
    fleet.rolling_restart(min_available=1)
    for sup in fleet.replicas:
        assert sup.status == "healthy"
        assert _compiles(sup.engine) == (2, 1, 0, 0, 0)
    # two replicas built, each rebuilt once: 4 warm builds, 3 programs each
    assert jit_events.aot_hits() == hits0 + 12
    outs = fleet.generate(PROMPTS, SamplingParams(max_new_tokens=MAX_NEW))
    assert [tuple(o.token_ids) for o in outs] == cold


# ------------------------------------------------------------ the CLI --
def _manifest_path(root):
    mdir = os.path.join(root, "manifests")
    (mname,) = os.listdir(mdir)
    return os.path.join(mdir, mname)


def test_warm_cli_verifies_full_cache(warm_pfx_cache, capsys):
    from paddle_tpu_torch.compilecache.__main__ import main

    root, _ = warm_pfx_cache
    assert main(["warm", "--manifest", _manifest_path(root)]) == 0
    assert "8/8 programs present" in capsys.readouterr().out


BUILDER_CFG = dict(PFX_CFG, max_batch_slots=2, max_model_len=32,
                   page_size=4, **GATES)


def test_warm_cli_reports_missing_and_builds_it(warm_pfx_cache, tmp_path,
                                                monkeypatch, capsys):
    from paddle_tpu_torch.compilecache.__main__ import main

    root, _ = warm_pfx_cache
    dst = str(tmp_path / "cache")
    shutil.copytree(root, dst)
    mpath = _manifest_path(dst)
    with open(mpath) as f:
        entries = json.load(f)["entries"]
    (cow,) = [e for e in entries if e["kind"] == "cow"]
    ArtifactStore(dst).remove(cow["store_key"])
    assert main(["warm", "--manifest", mpath]) == 3
    out = capsys.readouterr().out
    assert "MISSING" in out and "7/8 programs present" in out
    (tmp_path / "port_warm_builder.py").write_text(
        "from paddle_tpu_torch.models import LlamaConfig, "
        "LlamaForCausalLM\n"
        "from paddle_tpu_torch.serving import Engine, EngineConfig\n"
        f"CFG = {BUILDER_CFG!r}\n"
        "def build(cache_dir):\n"
        "    model = LlamaForCausalLM(LlamaConfig.tiny(), device='cpu', "
        "seed=0)\n"
        "    Engine(model, EngineConfig(compile_cache=cache_dir, **CFG))\n"
    )
    monkeypatch.syspath_prepend(str(tmp_path))
    sys.modules.pop("port_warm_builder", None)
    assert main(["warm", "--manifest", mpath,
                 "--builder", "port_warm_builder:build"]) == 0
    out = capsys.readouterr().out
    assert "1/8 program(s) missing" in out and "8/8 programs present" in out
    assert ArtifactStore(dst).contains(cow["store_key"])


# ---------------------------------------------------- the collector view --
def test_compilecache_series_exported(tmp_path):
    from paddle_tpu_torch.observability import get_registry

    cc = CompileCache(str(tmp_path))
    cc.metrics.hits = 3
    cc.metrics.fallbacks = 1
    snap = get_registry().snapshot()
    label = "{cache=" + cc.root + "}"
    assert snap["paddle_tpu_compilecache_hits_total" + label] == 3
    assert snap["paddle_tpu_compilecache_fallbacks_total" + label] == 1


def test_dump_marks_aot_hits_and_summarizes_cache_as_jax_does():
    import io

    from paddle_tpu.observability.__main__ import _render_dump as jax_render
    from paddle_tpu_torch.observability.__main__ import _render_dump

    payload = {
        "reason": "test", "pid": 1, "ts": 0.0,
        "compile_log": [
            {"ts": 0.0, "kind": "decode", "fn": "step", "signature": "s",
             "retrace": False},
            {"ts": 0.0, "kind": "aot-hit", "fn": "step", "signature": "s",
             "retrace": False, "elapsed_s": 0.01},
        ],
        "metrics": {
            "paddle_tpu_compilecache_hits_total{cache=/a}": 2.0,
            "paddle_tpu_compilecache_hits_total{cache=/b}": 1.0,
            "paddle_tpu_compilecache_misses_total{cache=/a}": 4.0,
            "paddle_tpu_compilecache_fallbacks_total{cache=/a}": 1.0,
        },
    }
    ours, theirs = io.StringIO(), io.StringIO()
    _render_dump(payload, ours)
    jax_render(payload, theirs)
    text = ours.getvalue()
    assert "compile  decode:step" in text
    assert "aot-hit  aot-hit:step" in text
    assert "hits=3 misses=4 fallbacks=1" in text
    assert "(aot-hit loads in log: 1)" in text
    block = text[text.index("-- compile cache"):]
    assert block.split("-- metrics")[0] == theirs.getvalue()[
        theirs.getvalue().index("-- compile cache"):].split("-- metrics")[0]
