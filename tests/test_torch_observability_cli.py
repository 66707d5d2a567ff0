"""``python -m paddle_tpu_torch.observability`` against the JAX package's
CLI on the CPU: the cases of ``tests/test_observability.py``'s
``test_dump_contents_and_cli`` on the port's flight recorder, the dump
renderer's sections on one payload through both renderers, the offline
``slo`` summary of one access log through both, ``top`` over the port's
scrape endpoint, the exit codes; and the fleet's spawn gate
(``FleetConfig(analysis_check=)``: JAX's values and default, and the
gate itself on a replica whose decode program syncs the host)."""
import io
import json
import os

import pytest
import torch

from paddle_tpu.observability import __main__ as jax_cli
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.analysis import AnalysisError
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import __main__ as cli


@pytest.fixture
def flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    return tmp_path


def _engine(**kw):
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    return serving.Engine(model, serving.EngineConfig(
        max_batch_slots=2, max_model_len=32, page_size=8, **kw))


def test_dump_contents_and_cli(flight_dir, capsys):
    obs.record("test", "marker", detail=1)
    path = obs.dump("unit-test", probes={"p": {"status": "ok"}})
    assert path and os.path.exists(path)
    payload = json.load(open(path))
    assert payload["reason"] == "unit-test"
    assert payload["probes"] == {"p": {"status": "ok"}}
    assert any(e["name"] == "marker" for e in payload["events"])
    assert "compile_log" in payload and "metrics" in payload
    assert obs.find_dumps(str(flight_dir))[0] == path
    assert cli.main(["dump", path]) == 0
    assert cli.main(["dump"]) == 0
    assert cli.main(["dump", "--list"]) == 0
    assert cli.main(["metrics"]) == 0
    out = capsys.readouterr().out
    assert f"# {path}" in out and "reason: unit-test" in out
    assert "-- probes " in out and "marker" in out


@pytest.mark.parametrize("argv,code", [
    (["dump"], 1),          # no postmortem in the directory
    ([], 2),                # no subcommand
    (["slo"], 2),           # neither --url nor --access-log
], ids=["dump_none", "no_command", "slo_usage"])
def test_exit_codes_as_jax(flight_dir, argv, code, capsys):
    assert cli.main(argv) == code
    assert jax_cli.main(argv) == code


_PAYLOAD = {
    "reason": "test", "pid": 7, "ts": 0.0,
    "probes": {"serving.engine.1": {"status": "ok", "queue_depth": 0}},
    "compile_log": [
        {"ts": 0.0, "fn": "serving.decode", "kind": "serving",
         "signature": "1:any_sample=False", "retrace": False,
         "elapsed_s": 0.25},
        {"ts": 1.0, "fn": "serving.decode", "kind": "serving",
         "signature": "1:any_sample=False", "retrace": True,
         "elapsed_s": None},
    ],
    "request_timelines": [{
        "rid": "r1", "finish_reason": "length", "queue_wait_s": 0.001,
        "ttft_s": 0.02, "tpot_s": 0.003, "e2e_s": 0.05,
        "prefill_chunks": 2, "preemptions": 1,
    }],
    "step_samples": [{
        "ts": 0.0, "engine": 3, "wall_ms": 12.5, "host_ms": 2.5,
        "launches": [["prefill", 6.0], ["decode", 4.0]],
        "tokens": 9, "occupancy": 0.75, "queue_depth": 2,
        "kv_headroom_blocks": 6,
    }],
    "events": [{"ts": 0.0, "category": "serving", "name": "step",
                "engine": "3"}],
    "metrics": {
        "paddle_tpu_serving_goodput_tokens_total"
        "{class=useful,engine=3}": 30,
        "paddle_tpu_serving_goodput_tokens_total"
        "{class=spec_reject,engine=3}": 6,
        "paddle_tpu_serving_goodput_fraction{engine=3}": 30 / 36,
        "paddle_tpu_serving_mfu{engine=3}": 0.0125,
        'paddle_tpu_serving_spill_host_bytes{engine="0"}': 4096.0,
        'paddle_tpu_serving_spill_host_capacity_bytes{engine="0"}':
            8192.0,
        'paddle_tpu_serving_spill_restore_hit_rate{engine="0"}': 1.0,
        'paddle_tpu_serving_spill_spilled_bytes_total'
        '{engine="0",class="request"}': 4096.0,
    },
}


def test_dump_render_sections_equal_jax():
    ours, theirs = io.StringIO(), io.StringIO()
    cli._render_dump(_PAYLOAD, ours)
    jax_cli._render_dump(_PAYLOAD, theirs)
    assert ours.getvalue() == theirs.getvalue()
    text = ours.getvalue()
    t = cli._fmt_ts(0.0)
    for section in ("-- probes ", "-- compile log (oldest first) ",
                    "-- last 1 request timelines ",
                    "-- last 1 step samples ",
                    "-- goodput ledger (tokens) ", "-- kv spill tier ",
                    "-- last 1 events ", "-- metrics snapshot "):
        assert section in text, section
    assert (f"  {t} eng=3 wall=12.5ms host=2.5ms occ=0.75 q=2 tok=9"
            " kv_headroom=6 [prefill=6.0ms decode=4.0ms]\n") in text
    assert "RETRACE" in text and "restore_hit_rate=1.000" in text


def test_slo_offline_equal_jax(tmp_path, capsys):
    from paddle_tpu_torch.serving.access_log import AccessLog

    al = AccessLog(tmp_path)
    for i in range(4):
        al.log({"finish_reason": "length", "queue_wait_s": 0.01 * i,
                "ttft_s": 0.02 + i, "tpot_s": 0.001, "e2e_s": 0.05 + i})
    al.log({"finish_reason": "aborted", "queue_wait_s": 0.01,
            "ttft_s": 5.0, "tpot_s": 0.001, "e2e_s": 5.0})
    al.close()
    argv = ["slo", "--access-log", str(tmp_path), "--ttft-p99-ms", "1000"]
    assert cli.main(argv) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(argv) == 0
    assert ours == capsys.readouterr().out
    assert "5 request(s): aborted=1 length=4" in ours
    assert "burn[ttft] vs p99 target" in ours
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["slo", "--access-log", str(empty)]) == 1


def test_top_and_slo_over_a_live_scrape(capsys):
    eng = _engine()
    eng.generate([[4, 5, 6]], serving.SamplingParams(max_new_tokens=4))
    srv = obs.start_scrape_server(port=0)
    try:
        assert cli.main(["top", "--url", srv.url]) == 0
        assert cli.main(["slo", "--url", srv.url]) == 0
    finally:
        srv.close()
    out = capsys.readouterr().out
    eid = str(eng.engine_id)
    assert f"engine {eid}" in out
    for prog in ("prefill", "decode"):
        assert prog in out
    assert f"kv headroom: engine {eid}" in out


# -- the fleet's spawn gate -----------------------------------------------
@pytest.mark.parametrize("value", ["error", "warn", None])
def test_fleet_config_takes_jax_values(value):
    assert serving.FleetConfig(analysis_check=value).analysis_check == value
    sup = serving.ReplicaSupervisor("r0", lambda: None,
                                    analysis_check=value)
    assert sup.analysis_check == value


def test_fleet_config_default_and_validation():
    assert serving.FleetConfig().analysis_check == "error"
    assert serving.ReplicaSupervisor("r0", lambda: None).analysis_check \
        == "error"
    with pytest.raises(ValueError, match="analysis_check"):
        serving.FleetConfig(analysis_check="maybe")


def _poisoned_engine():
    eng = _engine()
    real = eng._decode_fn

    def poisoned(f, pool, any_sample, gen):
        fn = real(f, pool, any_sample, gen)

        def decode_fn():
            nxt, logits = fn()
            return nxt + int(logits.argmax().item()), logits

        return decode_fn

    eng._decode_fn = poisoned
    return eng


def test_spawn_gate_runs_check_decode():
    sup = serving.ReplicaSupervisor("r0", _poisoned_engine)
    with pytest.raises(AnalysisError) as ei:
        sup.spawn()
    assert ei.value.report.by_rule("host-sync")
    assert sup.engine is None
    warned = serving.ReplicaSupervisor("r1", _poisoned_engine,
                                       analysis_check="warn")
    with pytest.warns(UserWarning, match="host-sync"):
        assert warned.spawn() is not None
    assert serving.ReplicaSupervisor(
        "r2", _poisoned_engine, analysis_check=None).spawn() is not None


def test_default_fleet_builds_and_serves():
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    fleet = serving.Fleet(model, serving.EngineConfig(
        max_batch_slots=2, max_model_len=32, page_size=8),
        serving.FleetConfig(num_replicas=2))
    assert fleet.config.analysis_check == "error"
    outs = fleet.generate([[1, 2, 3], [4, 5]],
                          serving.SamplingParams(max_new_tokens=3))
    assert [len(o.token_ids) for o in outs] == [3, 3]
