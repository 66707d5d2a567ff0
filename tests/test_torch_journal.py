"""The port's request journal (``paddle_tpu_torch.serving.journal``) on the
CPU, against the JAX package's:

  * the JAX package's unit cases: framing round-trip and emit cursor,
    re-admit dedup, torn tail, crc damage, compaction, idempotent replay,
    append and replay faults (degrade, never raise), the undurable finish,
    the ``SamplingParams`` round-trip with ``seed``, epoch brackets;
  * format parity: segments written by the JAX ``Journal`` replay in the
    port's to the same entries and report, and the reverse;
  * crash replay: a port engine abandoned mid-decode, a new one on the
    same directory finishes every request token for token as the
    uninterrupted port run and the JAX engine (tiny f32, converted
    weights), each delivered once; lapsed TTLs finish as ``timeout``; a
    seeded sampled request's first token survives a new life;
  * a SIGKILLed ``device="cpu"`` worker process recovers exactly once.
"""
import json
import os
import signal
import struct
import subprocess
import sys
import time

import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving.journal import Journal as JaxJournal
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.resilience import FaultSpec, faults
from paddle_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Journal,
    Request,
    SamplingParams,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FRAME = struct.Struct("<II")

PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11], [3, 1, 4], [9, 9]]
N_NEW = 8


def _req(rid, prompt=(1, 2, 3), **params):
    return Request(list(prompt), SamplingParams(**params), request_id=rid)


def _seg_path(j, idx=-1):
    return os.path.join(j.path, j.segments()[idx])


def _engine_config(**kw):
    return EngineConfig(**dict(dict(max_batch_slots=4, max_model_len=32,
                                    page_size=4, prefill_buckets=[32]),
                               **kw))


@pytest.fixture(scope="module")
def models():
    """A tiny JAX Llama and the port's model on its converted weights."""
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny())
    port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_reference_state(
        port, {k: v.numpy() for k, v in jax_model.state_dict().items()})
    return jax_model, port


@pytest.fixture(scope="module")
def ref(models):
    """The uninterrupted port run and the JAX engine's, same prompts."""
    jax_model, port = models
    params = SamplingParams(max_new_tokens=N_NEW)
    mine = Engine(port, _engine_config()).generate(PROMPTS, params)
    jeng = jax_serving.Engine(jax_model, jax_serving.EngineConfig(
        max_batch_slots=4, max_model_len=32, page_size=4,
        prefill_buckets=[32], analysis_check=None))
    theirs = jeng.generate(PROMPTS,
                           jax_serving.SamplingParams(max_new_tokens=N_NEW))
    return [o.token_ids for o in mine], [o.token_ids for o in theirs]


# -- the JAX package's unit cases -------------------------------------------
class TestJournalUnit:
    def test_roundtrip_and_cursor(self, tmp_path):
        j = Journal(str(tmp_path / "wal"), seed=7)
        assert j.replay() == []
        a, b = _req("a", [1, 2], max_new_tokens=4), _req("b", [3])
        j.admit(a)
        j.admit(b)
        a.output_token_ids += [10, 11]
        j.emit(a)
        j.flush()
        a.output_token_ids += [12]
        b.output_token_ids += [20]
        j.emit(a)
        j.emit(b)
        j.finish(b, "length")
        j.flush()
        j.emit(a)          # no new tokens: nothing buffered
        assert j.flush() == 0
        j2 = Journal(str(tmp_path / "wal"), seed=7)
        entries = j2.replay()
        assert [e.rid for e in entries] == ["a"]
        assert entries[0].prompt == [1, 2]
        assert entries[0].out == [10, 11, 12]
        assert entries[0].params["max_new_tokens"] == 4
        assert j2.replay_report["finished"] == 1

    def test_readmit_cursor_dedup(self, tmp_path):
        j = Journal(str(tmp_path / "wal"))
        a = _req("a")
        j.admit(a)
        a.output_token_ids += [1, 2, 3]
        j.emit(a)
        j.flush()
        j2 = Journal(str(tmp_path / "wal"))
        [e] = j2.replay()
        assert e.out == [1, 2, 3]
        r = _req("a")
        r.output_token_ids = list(e.out)
        j2.admit(r)
        r.output_token_ids += [4]
        j2.emit(r)
        j2.flush()
        [e3] = Journal(str(tmp_path / "wal")).replay()
        assert e3.out == [1, 2, 3, 4]   # latest ADMIT wins, no doubles

    def test_torn_tail_truncated(self, tmp_path):
        j = Journal(str(tmp_path / "wal"))
        j.admit(_req("a"))
        j.admit(_req("b"))
        j.flush()
        j.close()
        seg = _seg_path(j)
        good = os.path.getsize(seg)
        with open(seg, "ab") as f:
            f.write(_FRAME.pack(1 << 20, 0) + b"\x01\x02\x03")
        j2 = Journal(str(tmp_path / "wal"))
        with pytest.warns(UserWarning, match="torn tail"):
            entries = j2.replay()
        assert {e.rid for e in entries} == {"a", "b"}
        assert j2.replay_report["torn"] == 1 and j2.torn_tails == 1
        assert os.path.getsize(seg) == good

    def test_crc_damage_skips_one_record(self, tmp_path):
        j = Journal(str(tmp_path / "wal"))
        a, b = _req("a"), _req("b")
        j.admit(a)
        j.flush()
        a.output_token_ids += [1, 2]
        j.emit(a)
        j.flush()
        j.admit(b)
        j.flush()
        j.close()
        seg = _seg_path(j)
        data = bytearray(open(seg, "rb").read())
        off = 0
        while off < len(data):
            ln, _ = _FRAME.unpack_from(data, off)
            if json.loads(bytes(data[off + 8: off + 8 + ln]))["t"] == "E":
                data[off + 8] ^= 0xFF
                break
            off += 8 + ln
        else:
            pytest.fail("no EMIT record found")
        open(seg, "wb").write(bytes(data))
        j2 = Journal(str(tmp_path / "wal"))
        with pytest.warns(UserWarning, match="corrupt"):
            entries = j2.replay()
        by = {e.rid: e for e in entries}
        assert set(by) == {"a", "b"} and by["a"].out == []
        assert j2.replay_report["corrupt"] == 1

    def test_compaction_reclaims_finished_segments(self, tmp_path):
        j = Journal(str(tmp_path / "wal"), segment_bytes=128)
        reqs = [_req(f"r{i}") for i in range(6)]
        for r in reqs:
            j.admit(r)
            r.output_token_ids += [1, 2, 3, 4]
            j.emit(r)
            j.flush()
        assert len(j.segments()) > 2
        for r in reqs[:-1]:
            j.finish(r, "length")
        j.flush()
        assert j.open_requests() == {"r5"} and len(j.segments()) >= 1
        j.finish(reqs[-1], "length")
        j.flush()
        assert j.segments() == [j._seg_name]
        assert j.compacted_segments > 0

    def test_replay_idempotent_per_instance(self, tmp_path):
        j = Journal(str(tmp_path / "wal"))
        j.admit(_req("a"))
        j.flush()
        j.close()
        j2 = Journal(str(tmp_path / "wal"))
        assert len(j2.replay()) == 1
        assert j2.replay() == []

    def test_append_fault_degrades_to_warn_and_counter(self, tmp_path):
        j = Journal(str(tmp_path / "wal"))
        j.replay()
        j.admit(_req("a"))
        with faults.inject(
            {"journal.append": FaultSpec(OSError("disk full"))}
        ) as inj:
            with pytest.warns(UserWarning, match="append"):
                assert j.flush() == 0
            j.admit(_req("b"))
            assert j.flush() == 0         # counted, not warned again
        assert inj.fired["journal.append"] == 2 and j.append_errors == 2
        assert any(
            k.startswith("paddle_tpu_serving_journal_append_errors_total")
            and v == 2 for k, v in get_registry().snapshot().items())
        j.admit(_req("c"))
        assert j.flush() > 0              # recovers once the fault clears

    def test_undurable_finish_keeps_admit_segment_alive(self, tmp_path):
        j = Journal(str(tmp_path / "wal"), segment_bytes=64)
        a = _req("a")
        j.admit(a)
        j.flush(force=True)
        with faults.inject(
            {"journal.append": FaultSpec(OSError("disk hiccup"))}
        ):
            j.finish(a, "length")
            with pytest.warns(UserWarning, match="append"):
                assert j.flush(force=True) == 0
        assert "a" in j.open_requests()
        for i in range(4):
            b = _req(f"b{i}")
            j.admit(b)
            j.finish(b, "length")
            j.flush(force=True)
        j.close()
        assert "a" in {e.rid for e in Journal(str(tmp_path / "wal")).replay()}

    def test_replay_fault_degrades_to_empty_recovery(self, tmp_path):
        j = Journal(str(tmp_path / "wal"))
        j.admit(_req("a"))
        j.flush()
        j.close()
        j2 = Journal(str(tmp_path / "wal"))
        with faults.inject(
            {"journal.replay": FaultSpec(OSError("bad disk"))}
        ):
            with pytest.warns(UserWarning, match="replay"):
                assert j2.replay() == []
        assert "error" in j2.replay_report and j2.replay_errors == 1
        j2.admit(_req("b"))
        assert j2.flush() > 0

    def test_sampling_params_roundtrip_with_seed(self):
        p = SamplingParams(
            max_new_tokens=5, do_sample=True, temperature=0.7, top_k=3,
            top_p=0.9, eos_token_id=2, stop_token_ids=(7, 8), ttl_s=1.5,
            seed=42)
        q = SamplingParams.from_dict(p.to_dict())
        assert q.to_dict() == p.to_dict()
        assert q.seed == 42 and q.stop_ids == {2, 7, 8}
        d = dict(p.to_dict(), future_knob=1)
        assert SamplingParams.from_dict(d).to_dict() == p.to_dict()
        # the same dict as the JAX package's, key for key
        jp = jax_serving.SamplingParams(
            max_new_tokens=5, do_sample=True, temperature=0.7, top_k=3,
            top_p=0.9, eos_token_id=2, stop_token_ids=(7, 8), ttl_s=1.5,
            seed=42)
        assert jp.to_dict() == p.to_dict()


@pytest.mark.parametrize("ops,epochs,interrupted", [
    ([("shrink-begin", "r0")], 1, ["shrink@r0"]),
    ([("shrink-begin", "r0"), ("shrink-end", "r0"), ("scale-up", None)],
     3, []),
    ([("restart-begin", "r0"), ("restart-begin", "r1"),
      ("restart-end", "r0")], 3, ["restart@r1"]),
], ids=["unclosed", "closed", "per_replica"])
def test_epoch_brackets(tmp_path, ops, epochs, interrupted):
    j = Journal(str(tmp_path / "wal"))
    j.admit(_req("a"))
    for op, rep in ops:
        j.epoch(op, replica=rep)
    j.flush()
    j2 = Journal(str(tmp_path / "wal"))
    [e] = j2.replay()
    assert e.rid == "a"   # R records never disturb request replay
    assert j2.replay_report["epochs"] == epochs
    assert j2.replay_report["interrupted_ops"] == interrupted
    # numbering resumes past the journal's max
    assert j2.epoch("scale-up") == epochs + 1


# -- format parity with the JAX package --------------------------------------
def _write_history(journal_cls, request_cls, params_cls, path):
    """The same lifecycle through either package's Journal: a finished
    request, an open one with emitted tokens and a tenant, an aborted
    one, an open seeded one and an epoch bracket."""
    j = journal_cls(path, seed=3)
    j.replay()
    reqs = [
        request_cls([1, 2, 3], params_cls(max_new_tokens=4),
                    request_id=7),
        request_cls([4, 5], params_cls(max_new_tokens=6, ttl_s=600.0),
                    request_id="s-1"),
        request_cls([6], params_cls(max_new_tokens=2), request_id=9),
        request_cls([8, 9], params_cls(max_new_tokens=5, do_sample=True,
                                       temperature=0.5, seed=11),
                    request_id=10),
    ]
    reqs[1].tenant = "gold"
    for r in reqs:
        j.admit(r)
    j.epoch("shrink-begin", replica="r0")
    j.flush()
    reqs[0].output_token_ids += [11, 12, 13, 14]
    reqs[1].output_token_ids += [21, 22]
    reqs[3].output_token_ids += [31]
    for r in reqs:
        j.emit(r)
    j.finish(reqs[0], "length")
    j.finish(reqs[2], "aborted")
    j.flush(force=True)
    j.close()


def _replayed(journal_cls, path):
    j = journal_cls(path, seed=3)
    entries = j.replay()
    rep = dict(j.replay_report)
    return [(e.rid, e.prompt, e.params, e.out, e.tenant, e.kv, e.ts)
            for e in entries], rep


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_segments_replay_across_packages(tmp_path, writer):
    pkgs = {
        "jax": (JaxJournal, jax_serving.Request, jax_serving.SamplingParams),
        "port": (Journal, Request, SamplingParams),
    }
    path = str(tmp_path / "wal")
    _write_history(*pkgs[writer], path)
    # read twice: once by each package, from copies of the same bytes
    # (a replay opens a fresh segment of its own)
    import shutil

    other = str(tmp_path / "copy")
    shutil.copytree(path, other)
    theirs, rep_j = _replayed(JaxJournal, path)
    mine, rep_p = _replayed(Journal, other)
    assert mine == theirs
    assert rep_p == rep_j
    assert [e[0] for e in mine] == ["s-1", 10]
    assert mine[0][3] == [21, 22] and mine[0][4] == "gold"
    assert SamplingParams.from_dict(mine[1][2]).seed == 11
    assert rep_p["interrupted_ops"] == ["shrink@r0"]


# -- engine recovery ----------------------------------------------------------
def test_crash_replay_matches_uninterrupted_and_jax(models, ref, tmp_path):
    _, port = models
    mine, theirs = ref
    jdir = str(tmp_path / "wal")
    eng = Engine(port, _engine_config(journal=jdir))
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=N_NEW))
            for p in PROMPTS]
    outs1 = []
    for _ in range(5):           # mid-decode
        outs1.extend(eng.step())
    # CRASH: abandon the engine (no shutdown hook runs)
    eng2 = Engine(port, _engine_config(journal=jdir))
    done = {o.request_id for o in outs1}
    assert eng2.journal.replay_report["unfinished"] == len(PROMPTS) - len(
        done)
    # re-admitted at the queue head, oldest first, tokens restored
    assert [r.request_id for r in eng2.waiting] == [
        r.request_id for r in reqs if r.request_id not in done]
    assert all(r.timeline.recovered for r in eng2.waiting)
    outs2 = []
    while eng2.has_unfinished():
        outs2.extend(eng2.step())
    got = {o.request_id: o for o in outs1 + outs2}
    assert len(got) == len(outs1) + len(outs2) == len(PROMPTS)
    for r, want_port, want_jax in zip(reqs, mine, theirs):
        assert got[r.request_id].token_ids == want_port == want_jax
    assert eng2.block_manager.num_used == 0
    # fresh request ids never collide with the journaled ones
    nxt = eng2.add_request([5, 5], SamplingParams(max_new_tokens=2))
    assert nxt.request_id not in {r.request_id for r in reqs}
    # drained: a third life replays nothing
    assert Journal(jdir).replay() == []


def test_lapsed_ttl_finishes_as_timeout(models, tmp_path):
    _, port = models
    jdir = str(tmp_path / "wal")
    j = Journal(jdir, seed=0)
    j.replay()
    j.admit(_req("t1", [1, 2, 3], max_new_tokens=4, ttl_s=0.01))
    j.admit(_req("t2", [4, 5], max_new_tokens=4))
    j.flush(force=True)
    j.close()
    time.sleep(0.05)              # t1's deadline lapses "while down"
    eng = Engine(port, _engine_config(journal=jdir))
    assert eng.metrics.requests_timeout == 1
    assert [r.request_id for r in eng.waiting] == ["t2"]
    while eng.has_unfinished():
        eng.step()
    # the retirement was durable: nothing is left to replay
    assert Journal(jdir).replay() == []


def test_seeded_sampled_first_token_stable_across_lives(models, tmp_path):
    _, port = models
    sp = SamplingParams(max_new_tokens=6, do_sample=True, temperature=0.8,
                        seed=123)
    jdir = str(tmp_path / "wal")
    # life 1 carries history (an unrelated sampled request) and dies
    # after the seeded request's admission was journaled, before its
    # prefill ran
    eng = Engine(port, _engine_config(journal=jdir, seed=0))
    eng.generate([[7, 8]], SamplingParams(max_new_tokens=3, do_sample=True))
    eng.add_request([1, 2, 3], sp, request_id="seeded")
    eng.journal.flush()
    # life 2, another engine seed: the recovered request's first token
    with pytest.warns(UserWarning, match="different engine seed"):
        eng2 = Engine(port, _engine_config(journal=jdir, seed=9))
    outs = []
    while eng2.has_unfinished():
        outs.extend(eng2.step())
    [out] = outs
    assert out.request_id == "seeded" and len(out.token_ids) == 6
    # a fresh engine with no history and a third seed agrees
    fresh = Engine(port, _engine_config(seed=5))
    assert fresh.generate([[1, 2, 3]], sp)[0].token_ids[0] == \
        out.token_ids[0]


_WORKER = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
jdir, out_path, kill_at = sys.argv[2], sys.argv[3], int(sys.argv[4])
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)
eng = Engine(model, EngineConfig(max_batch_slots=4, max_model_len=32,
                                 page_size=4, prefill_buckets=[32],
                                 journal=jdir))
if kill_at >= 0:
    for i in range(8):
        eng.add_request([i + 1, i + 2, i + 3],
                        SamplingParams(max_new_tokens=4 + 2 * i),
                        request_id=f"req-{i}")
out = open(out_path, "a")
while eng.has_unfinished():
    if kill_at > 0 and eng.metrics.decode_tokens >= kill_at:
        os.kill(os.getpid(), 9)
    for o in eng.step():
        out.write(json.dumps({"rid": o.request_id, "tokens": o.token_ids,
                              "reason": o.finish_reason}) + "\n")
        out.flush()
        os.fsync(out.fileno())
"""


def test_sigkill_worker_recovers_exactly_once(tmp_path):
    """A real process SIGKILLed mid-decode; a second one on the same
    journal (submitting nothing) delivers the rest: the union is every
    request once, token for token as an uninterrupted run."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)

    def run(jdir, out, kill_at):
        return subprocess.run(
            [sys.executable, str(script), REPO, jdir, out, str(kill_at)],
            capture_output=True, text=True, timeout=120)

    def outputs(path):
        by = {}
        if os.path.exists(path):
            for line in open(path):
                rec = json.loads(line)
                assert rec["rid"] not in by, "request delivered twice"
                by[rec["rid"]] = rec
        return by

    p = run(str(tmp_path / "wal-ref"), str(tmp_path / "ref.jsonl"), 0)
    assert p.returncode == 0, p.stderr
    ref = outputs(str(tmp_path / "ref.jsonl"))
    assert len(ref) == 8
    jdir = str(tmp_path / "wal")
    p = run(jdir, str(tmp_path / "killed.jsonl"), 20)
    assert p.returncode == -signal.SIGKILL, p.stderr
    killed = outputs(str(tmp_path / "killed.jsonl"))
    assert 0 < len(killed) < 8
    p = run(jdir, str(tmp_path / "recovered.jsonl"), -1)
    assert p.returncode == 0, p.stderr
    recovered = outputs(str(tmp_path / "recovered.jsonl"))
    assert not set(killed) & set(recovered)
    assert set(killed) | set(recovered) == set(ref)
    for rid, want in ref.items():
        got = killed.get(rid) or recovered[rid]
        assert (got["tokens"], got["reason"]) == (want["tokens"],
                                                  want["reason"])
