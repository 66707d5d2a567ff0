"""The port's self-healing fleet (``paddle_tpu_torch.serving.fleet`` and
``supervisor``) against the JAX package's, on the CPU: the scenarios of
``tests/test_fleet.py`` that need no placement plan and no analyzer, each
run on a JAX fleet and on a port fleet over the same tiny Llama weights,
with the same seed and fault schedule. Compared: finish reasons and
greedy tokens, the replica each request was dispatched to, and the
``FleetMetrics`` counters (failovers, failover requests, hedges, restarts,
failed replicas, shed, timeouts, route errors, prefix-affinity routes).

Left out of ``tests/test_fleet.py``: ``test_spawn_gate_runs_check_decode``
(the spawn gate, ``Engine.check_decode``, is held to its contract in
``tests/test_torch_observability_cli.py``; the fleets here pass
``analysis_check=None`` as the JAX ones do) and
``test_width_normalized_load_and_per_chip_headroom`` (tensor-parallel
width and a sharded pool: every port replica is one device wide; the
headroom tie-break is tested).
"""
import collections
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.resilience import FaultSpec as JaxFaultSpec
from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.resilience import FaultSpec, faults

GEO = dict(max_batch_slots=4, max_model_len=32, page_size=4,
           prefill_buckets=[32])
# the counters compared between the two fleets
COUNTERS = ("requests_received", "requests_finished", "requests_shed",
            "requests_timeout", "journal_replayed", "failovers",
            "failover_requests", "hedges_started", "hedges_won",
            "hedges_lost", "restarts", "replicas_failed", "route_errors",
            "route_prefix_hits", "requests_migrated", "scale_downs")

Side = collections.namedtuple(
    "Side", "name serving model faults FaultSpec")


@pytest.fixture(scope="module")
def sides():
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny())
    port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_reference_state(
        port, {k: v.numpy() for k, v in jax_model.state_dict().items()})
    return (Side("jax", jax_serving, jax_model, jax_faults, JaxFaultSpec),
            Side("port", serving, port, faults, FaultSpec))


def _fleet(side, fleet_kw=None, **engine_kw):
    s = side.serving
    return s.Fleet(side.model, s.EngineConfig(**dict(GEO, **engine_kw)),
                   s.FleetConfig(**dict(dict(num_replicas=2,
                                             analysis_check=None),
                                        **(fleet_kw or {}))))


def _params(side, **kw):
    return side.serving.SamplingParams(**kw)


def _wait_settled(fleet, name, timeout=20.0):
    """Step the fleet until a quarantined replica's background restart
    resolves (healthy or failed)."""
    sup = fleet.replica(name)
    deadline = time.time() + timeout
    while sup.status == "quarantined" and time.time() < deadline:
        sup.join_restart(0.5)
        fleet.step()
    return sup.status


def _drain(fleet, reqs, limit=500):
    for _ in range(limit):
        if all(r.done for r in reqs) and not fleet.has_unfinished():
            return
        fleet.step()
    raise AssertionError("fleet did not drain")


def _summary(fleet, reqs):
    """What the two fleets must agree on: per request (in submission
    order) its finish reason, tokens and the replicas its surviving
    dispatches ran on; the fleet counters."""
    return {
        "requests": [(r.output.finish_reason, r.output.token_ids,
                      [(d.replica, d.kind) for d in r.dispatches])
                     for r in reqs],
        "counters": {k: getattr(fleet.metrics, k) for k in COUNTERS},
    }


def _both(sides, scenario):
    """Run ``scenario(side)`` on the JAX fleet and the port's; assert
    they return the same summary and return it."""
    got = {side.name: scenario(side) for side in sides}
    assert got["port"] == got["jax"]
    return got["port"]


def _prompts(n=16, seed=42):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, int(k)).tolist()
            for k in rng.choice([3, 5, 7, 9], n)]


def _kill(side, replica, at=None, **kw):
    return side.FaultSpec(
        RuntimeError("replica torn"),
        when=lambda c: (c.get("phase") == "step"
                        and c.get("replica") == replica), at=at, **kw)


# -- failover ----------------------------------------------------------------
def test_kill_mid_decode_failover(sides, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    prompts = _prompts()

    def scenario(side):
        fleet = _fleet(side)
        params = _params(side, max_new_tokens=8)
        warm = fleet.generate(prompts, params)
        reqs = [fleet.add_request(p, params) for p in prompts]
        with side.faults.inject({"serving.replica": _kill(side, "r0", 4)}
                                ) as inj:
            _drain(fleet, reqs)
        assert inj.fired == {"serving.replica": 1}
        m = fleet.metrics
        assert m.failovers == 1 and m.failover_requests >= 1
        assert m.failover_recovery_s is not None
        # the dead replica's digests were folded into the fleet's
        assert fleet.merged_latency()["e2e"].count == 2 * len(prompts)
        assert fleet.replica("r1").engine.metrics.decode_compiles == 1
        # the killed replica restarts in the background and rejoins
        assert _wait_settled(fleet, "r0") == "healthy"
        assert fleet.replica("r0").restarts == 1 and fleet.size() == 2
        again = fleet.generate(prompts[:4], params)
        assert fleet.merged_latency()["e2e"].count == 2 * len(prompts) + 4
        return dict(_summary(fleet, reqs),
                    warm=[o.token_ids for o in warm],
                    again=[o.token_ids for o in again])

    got = _both(sides, scenario)
    # token for token the uninterrupted run's
    assert [r[1] for r in got["requests"]] == got["warm"]
    assert got["again"] == got["warm"][:4]
    assert got["counters"]["restarts"] == 1


def test_failover_metrics_and_postmortem(sides, tmp_path, monkeypatch):
    """The port's fleet publishes the failover counter and per-replica
    series in the process registry, and a replica death dumps a flight
    postmortem holding the failover events, as JAX's does."""
    from paddle_tpu_torch.observability import get_registry

    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    side = sides[1]
    fleet = _fleet(side)
    params = _params(side, max_new_tokens=8)
    reqs = [fleet.add_request(p, params) for p in _prompts(8)]
    with faults.inject({"serving.replica": _kill(side, "r0", 3)}):
        _drain(fleet, reqs)
    snap = get_registry().snapshot()
    label = f"{{fleet={fleet.fleet_id}}}"
    assert snap["paddle_tpu_fleet_failovers_total" + label] == 1
    survivor = f"{{fleet={fleet.fleet_id},replica=r1}}"
    assert snap["paddle_tpu_fleet_replica_prefill_tokens_total"
                + survivor] > 0
    assert snap["paddle_tpu_fleet_replica_prefix_hit_tokens_total"
                + survivor] == 0
    dumps = sorted(tmp_path.glob("paddle_tpu-flight-*.json"))
    assert dumps, "replica death left no postmortem"
    payload = json.loads(dumps[0].read_text())
    assert payload["reason"] == "replica-death:r0"
    events = [e for e in payload["events"] if e.get("category") == "fleet"
              and e.get("fleet") == fleet.fleet_id]
    assert any(e["name"] == "replica-death" for e in events)
    assert (sum(e["name"] == "failover" for e in events)
            == fleet.metrics.failover_requests)
    assert any("serving.replica.r0" in k for k in payload["probes"])


# -- hedging -----------------------------------------------------------------
def test_hedge_winner_loser_accounting(sides):
    def scenario(side):
        fleet = _fleet(side, dict(hedge_after_s=0.0), max_batch_slots=2)
        params = _params(side, max_new_tokens=6)
        reqs = [fleet.add_request(p, params)
                for p in ([1, 2, 3], [4, 5, 6, 7])]
        _drain(fleet, reqs)
        m = fleet.metrics
        assert m.hedges_started == 2
        assert m.hedges_won + m.hedges_lost == m.hedges_started
        assert m.hedges_won >= 1
        # the losers were aborted, not leaked
        assert not fleet.has_unfinished()
        assert all(s.engine.block_manager.num_used == 0
                   for s in fleet.replicas)
        return _summary(fleet, reqs)

    _both(sides, scenario)


@pytest.mark.parametrize("hedge", [0.02, None], ids=["anchored", "off"])
def test_hedge_anchors_and_default_off(sides, hedge):
    """A hedge serves the SAME client request: its timeline and TTL
    anchor at the primary's arrival, so a hedge win reports the stall
    the client waited through. Without ``hedge_after_s`` nothing is
    hedged."""
    def scenario(side):
        fleet = _fleet(side, dict(hedge_after_s=hedge), max_batch_slots=2)
        freq = fleet.add_request([1, 2, 3], _params(side, max_new_tokens=8))
        fleet.step()            # primary dispatched
        time.sleep(0.05)        # stall past the hedge deadline
        fleet.step()
        hd = next((d for d in fleet._routes.values() if d.kind == "hedge"),
                  None)
        if hedge is None:
            assert hd is None
        else:
            prim = hd.fleet_req.request
            assert hd.request.arrival_time == prim.arrival_time
            assert hd.request.timeline.arrival == prim.timeline.arrival
            assert hd.request.deadline == prim.deadline
        _drain(fleet, [freq])
        assert freq.output.metrics["e2e_s"] >= 0.05
        return _summary(fleet, [freq])

    got = _both(sides, scenario)
    assert got["counters"]["hedges_started"] == (0 if hedge is None else 1)


# -- drain / rolling restart --------------------------------------------------
def test_drain_stops_admission_and_waits_out_work(sides):
    def scenario(side):
        fleet = _fleet(side)
        params = _params(side, max_new_tokens=6)
        reqs = [fleet.add_request([i + 1, i + 2], params) for i in range(4)]
        fleet.step()
        fleet.drain("r0")
        r0 = fleet.replica("r0")
        assert r0.status == "draining" and not r0.engine.has_unfinished()
        # a draining replica receives no new work
        nr = fleet.add_request([9, 9], params)
        fleet.step()
        assert fleet._routes[nr.request_id].replica == "r1"
        fleet.resume_replica("r0")
        assert r0.status == "healthy"
        _drain(fleet, reqs + [nr])
        return _summary(fleet, reqs + [nr])

    _both(sides, scenario)


def test_rolling_restart_min_available(sides):
    prompts = [[i + 1, i + 2, i + 3] for i in range(6)]

    def scenario(side):
        fleet = _fleet(side)
        params = _params(side, max_new_tokens=6)
        reqs = [fleet.add_request(p, params) for p in prompts]
        fleet.step()
        # min_available == live count leaves nothing to restart
        with pytest.raises(ValueError, match="min_available"):
            fleet.rolling_restart(min_available=2)
        old = {s.name: s.engine.engine_id for s in fleet.replicas}
        fleet.rolling_restart(min_available=1, model=side.model)
        new = {s.name: s.engine.engine_id for s in fleet.replicas}
        assert all(old[k] != new[k] for k in old)
        assert all(s.status == "healthy" for s in fleet.replicas)
        # operator restarts spend no crash-restart budget
        assert all(s.restarts == 0 for s in fleet.replicas)
        _drain(fleet, reqs)
        ref = side.serving.Engine(side.model, side.serving.EngineConfig(
            **GEO)).generate(prompts, params)
        assert [r.output.token_ids for r in reqs] == [
            o.token_ids for o in ref]
        return _summary(fleet, reqs)

    got = _both(sides, scenario)
    assert got["counters"]["restarts"] == 2
    assert got["counters"]["requests_migrated"] >= 1


def test_scale_down_migrates_and_scale_up_needs_a_plan(sides):
    def scenario(side):
        fleet = _fleet(side)
        params = _params(side, max_new_tokens=6)
        reqs = [fleet.add_request([i + 1, i + 5], params) for i in range(4)]
        fleet.step()
        gone = fleet.scale_down(replica="r0")
        assert gone.status == "released" and fleet.size() == 1
        # never shrink away the last serving replica
        assert fleet.scale_down() is None
        with pytest.raises(RuntimeError, match="placement"):
            fleet.scale_up()
        _drain(fleet, reqs)
        return _summary(fleet, reqs)

    got = _both(sides, scenario)
    assert got["counters"]["scale_downs"] == 1
    assert all(r[0] == "length" for r in got["requests"])


# -- restart budget -----------------------------------------------------------
def test_budget_exhaustion_shrinks_fleet(sides):
    def scenario(side):
        fleet = _fleet(side)
        params = _params(side, max_new_tokens=4)
        specs = {"serving.replica": [
            _kill(side, "r0", 2),
            # every restart attempt fails: the retry policy exhausts and
            # the replica is marked permanently failed
            side.FaultSpec(OSError("no host"),
                           when=lambda c: c.get("phase") == "restart"),
        ]}
        reqs = [fleet.add_request([1, 2, 3], params) for _ in range(6)]
        with side.faults.inject(specs) as inj:
            _drain(fleet, reqs)
            status = _wait_settled(fleet, "r0")
        assert status == "failed"
        assert inj.fired["serving.replica"] >= 2   # kill + restarts
        assert fleet.size() == 1
        more = fleet.generate([[7, 8]] * 2, params)
        assert [o.finish_reason for o in more] == ["length"] * 2
        h = fleet.health()
        assert h["status"] == "ok" and h["replicas"]["r0"] == "failed"
        return _summary(fleet, reqs)

    got = _both(sides, scenario)
    assert all(r[0] == "length" for r in got["requests"])
    assert got["counters"]["replicas_failed"] == 1
    assert got["counters"]["failovers"] == 1


def test_zero_budget_fails_immediately(sides):
    def scenario(side):
        fleet = _fleet(side, dict(max_restarts=0))
        params = _params(side, max_new_tokens=2)
        reqs = [fleet.add_request([1, 2], params) for _ in range(4)]
        with side.faults.inject({"serving.replica": _kill(side, "r1", 1)}):
            _drain(fleet, reqs)
        assert fleet.replica("r1").status == "failed"
        assert fleet.size() == 1
        return _summary(fleet, reqs)

    _both(sides, scenario)


# -- API ----------------------------------------------------------------------
def test_config_validation_as_jax(sides):
    for side in sides:
        cfg = side.serving.FleetConfig
        with pytest.raises(ValueError, match="num_replicas"):
            cfg(num_replicas=0)
        with pytest.raises(ValueError, match="hedge_after_s"):
            cfg(hedge_after_s=-1.0)
        with pytest.raises(ValueError, match="max_restarts"):
            cfg(max_restarts=-1)
        with pytest.raises(ValueError, match="analysis_check"):
            cfg(analysis_check="maybe")
        with pytest.raises(ValueError, match="max_pending"):
            cfg(max_pending=0)


@pytest.mark.parametrize("kw,needle", [
    (dict(placement=object()), "tensor parallelism"),
    (dict(scaling=object()), "tensor parallelism"),
    (dict(analysis_check="error"), None),
    (dict(analysis_check="warn"), None),
], ids=["placement", "scaling", "analysis_error", "analysis_warn"])
def test_unported_fleet_options_are_refused_by_name(kw, needle):
    """Options that wait for tensor parallelism are refused by name; the
    spawn gate's settings (the analyzer is ported) are taken as the JAX
    fleet takes them (``needle`` None)."""
    if needle is None:
        assert serving.FleetConfig(**kw).analysis_check == \
            kw["analysis_check"]
        sup = serving.ReplicaSupervisor("r0", lambda: None, **kw)
        assert sup.analysis_check == kw["analysis_check"]
    else:
        with pytest.raises(NotImplementedError, match=needle):
            serving.FleetConfig(**kw)
    # the JAX default: every spawn runs the gate
    assert serving.FleetConfig().analysis_check == "error"


def test_engine_journal_under_fleet_refused(sides, tmp_path):
    for side in sides:
        with pytest.raises(ValueError, match="journal_dir"):
            _fleet(side, dict(num_replicas=1),
                   journal=str(tmp_path / side.name))


def test_route_fault_degrades_to_retry(sides):
    def scenario(side):
        fleet = _fleet(side)
        spec = side.FaultSpec(RuntimeError("router glitch"), at=1)
        with side.faults.inject({"fleet.route": spec}) as inj:
            freq = fleet.add_request([1, 2, 3],
                                     _params(side, max_new_tokens=3))
            _drain(fleet, [freq])
        assert inj.fired == {"fleet.route": 1}
        return _summary(fleet, [freq])

    got = _both(sides, scenario)
    assert got["counters"]["route_errors"] == 1
    assert got["requests"][0][0] == "length"


def test_abort_pending_and_dispatched(sides):
    def scenario(side):
        fleet = _fleet(side, dict(num_replicas=1), max_batch_slots=1,
                       max_waiting=1)
        params = _params(side, max_new_tokens=8)
        r1 = fleet.add_request([1, 2, 3], params)
        fleet.step()                            # r1 running
        r2 = fleet.add_request([4, 5], params)  # engine queue full ...
        r3 = fleet.add_request([6, 7], params)  # ... r3 stays pending
        assert fleet._routes.get(r3.request_id) is None
        assert fleet.abort(r3.request_id)      # fleet-pending abort
        assert r3.done and r3.output.finish_reason == "aborted"
        assert fleet.abort(r1.request_id)      # running on a replica
        _drain(fleet, [r1, r2, r3])
        assert not fleet.abort("nope")
        return _summary(fleet, [r1, r2, r3])

    got = _both(sides, scenario)
    assert [r[0] for r in got["requests"]] == ["aborted", "length",
                                                "aborted"]


def test_prompt_too_long_raises_at_add(sides):
    for side in sides:
        fleet = _fleet(side, dict(num_replicas=1))
        with pytest.raises(ValueError, match="no room"):
            fleet.add_request(list(range(1, 33)))


def test_degraded_history_does_not_unroute(sides):
    """Engine "degraded" is cumulative: one expired request gates
    admission for ONE routable() sweep, not forever."""
    def scenario(side):
        fleet = _fleet(side, dict(num_replicas=1))
        sup = fleet.replica("r0")
        out = fleet.generate(
            [[1, 2, 3]], _params(side, max_new_tokens=4, ttl_s=0.0))[0]
        assert out.finish_reason == "timeout"
        assert "degraded" in sup.engine.health()["flags"]
        sup.observe_errors()             # the per-step watermark sweep
        assert sup.routable() is False   # the NEW error gates this step
        assert sup.routable() is False   # ... and reads don't consume it
        sup.observe_errors()             # next step: no new errors
        assert sup.routable() is True
        more = fleet.generate([[4, 5]], _params(side, max_new_tokens=2))
        return [out.finish_reason, more[0].finish_reason,
                more[0].token_ids]

    assert _both(sides, scenario)[:2] == ["timeout", "length"]


def test_abort_then_replica_death_delivers_abort(sides):
    def scenario(side):
        fleet = _fleet(side, dict(max_restarts=0))
        params = _params(side, max_new_tokens=8)
        reqs = [fleet.add_request([1, 2, 3 + i], params) for i in range(4)]
        fleet.step()  # everything prefilled across both replicas
        victim = next(r for r in reqs
                      if fleet._routes[r.request_id].replica == "r0")
        assert fleet.abort(victim.request_id)
        with side.faults.inject({"serving.replica": _kill(side, "r0")}):
            _drain(fleet, reqs, limit=300)
        assert victim.output.finish_reason == "aborted"
        return _summary(fleet, reqs)

    got = _both(sides, scenario)
    assert got["counters"]["failovers"] == 1
    assert sorted(r[0] for r in got["requests"]) == [
        "aborted", "length", "length", "length"]


# -- bounded admission --------------------------------------------------------
def test_max_pending_sheds_with_engine_semantics(sides):
    def scenario(side):
        fleet = _fleet(side, dict(num_replicas=1, max_pending=1),
                       max_batch_slots=1, max_waiting=1)
        params = _params(side, max_new_tokens=8)
        reqs = [fleet.add_request([1, 2, 3], params),   # engine queue
                fleet.add_request([4, 5], params)]      # parks
        assert len(fleet._pending) == 1
        with pytest.raises(side.serving.EngineOverloadedError,
                           match="shed"):
            fleet.add_request([6, 7], params)
        _drain(fleet, reqs)
        assert fleet.snapshot()["requests_shed"] == 1
        return _summary(fleet, reqs)

    got = _both(sides, scenario)
    assert got["counters"]["requests_shed"] == 1
    assert got["counters"]["requests_finished"] == 2


def test_pending_ttl_expires_parked_requests(sides):
    def scenario(side):
        fleet = _fleet(side, dict(num_replicas=1), max_batch_slots=1,
                       max_waiting=1)
        params = _params(side, max_new_tokens=8)
        reqs = [fleet.add_request([1, 2, 3], params)]
        fleet.step()                                  # running
        reqs.append(fleet.add_request([4, 5], params))  # engine queue
        doomed = fleet.add_request(
            [6, 7], _params(side, max_new_tokens=8, ttl_s=0.0))  # parks
        assert doomed.request_id not in fleet._routes
        fleet.step()
        assert doomed.done and doomed.output.finish_reason == "timeout"
        _drain(fleet, reqs + [doomed])
        return _summary(fleet, reqs + [doomed])

    got = _both(sides, scenario)
    assert got["counters"]["requests_timeout"] == 1
    assert got["counters"]["requests_finished"] == 3


# -- routing ------------------------------------------------------------------
def test_repeated_system_prompt_routes_to_warm_replica(sides):
    sys_prefix = list(range(40, 52))        # 3 full blocks

    def scenario(side):
        fleet = _fleet(side, enable_prefix_cache=True)
        params = _params(side, max_new_tokens=2)
        first = fleet.add_request(sys_prefix + [90, 91], params)
        _drain(fleet, [first])
        warm = next(s for s in fleet.replicas
                    if s.engine.metrics.prefill_tokens > 0)
        cold = next(s for s in fleet.replicas if s is not warm)
        assert len(warm.engine.health()["prefix_cache_digests"]) == 3
        assert not cold.engine.health()["prefix_cache_digests"]
        second = fleet.add_request(sys_prefix + [95, 96], params)
        _drain(fleet, [second])
        assert warm.engine.metrics.prefix_hits >= 1
        assert cold.engine.metrics.prefill_tokens == 0
        return dict(_summary(fleet, [first, second]), warm=warm.name,
                    digests=list(
                        warm.engine.health()["prefix_cache_digests"]))

    got = _both(sides, scenario)
    assert got["counters"]["route_prefix_hits"] >= 1


def test_headroom_breaks_equal_prefix_depth_tie(sides):
    sys_prefix = list(range(40, 52))

    def scenario(side):
        fleet = _fleet(side, enable_prefix_cache=True)
        a, b = fleet.replicas
        params = _params(side, max_new_tokens=2)
        # warm BOTH replicas with the same chain: affinity alone cannot
        # separate them
        for sup in (a, b):
            sup.engine.generate([sys_prefix + [90, 91]], params)
        freq = fleet.add_request(sys_prefix + [95, 96], params)
        picks = []
        for ha, hb in ((4, 12), (12, 4)):
            a.engine.metrics.kv_headroom_blocks = ha
            b.engine.metrics.kv_headroom_blocks = hb
            target, affinity = fleet._route_target(freq, {a: 0, b: 0})
            assert affinity
            picks.append(target.name)
        fleet.abort(freq.request_id)
        return picks

    assert _both(sides, scenario) == ["r1", "r0"]


# -- front-door journal -------------------------------------------------------
def test_fleet_journal_replay_after_crash_exactly_once(sides, tmp_path):
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14],
               [15, 16, 17], [18, 19]]

    def scenario(side):
        jdir = str(tmp_path / side.name)
        params = _params(side, max_new_tokens=10)
        fleet = _fleet(side, dict(num_replicas=1, journal_dir=jdir))
        reqs = [fleet.add_request(p, params) for p in prompts]
        for _ in range(5):
            fleet.step()
        done1 = {r.request_id: r.output.token_ids for r in reqs if r.done}
        # CRASH: abandon the fleet (no hooks run), rebuild on the dir
        fleet2 = _fleet(side, dict(num_replicas=1, journal_dir=jdir))
        assert fleet2.metrics.journal_replayed == len(prompts) - len(done1)
        got = dict(done1)
        for _ in range(500):
            if not fleet2.has_unfinished():
                break
            for out in fleet2.step():
                assert out.request_id not in got, "delivered twice"
                got[out.request_id] = out.token_ids
        assert len(got) == len(prompts)
        ref = side.serving.Engine(side.model, side.serving.EngineConfig(
            **GEO)).generate(prompts, params)
        assert [got[r.request_id] for r in reqs] == [
            o.token_ids for o in ref]
        # fresh rids never collide with replayed ones
        nxt = fleet2.add_request([5, 5], _params(side, max_new_tokens=2))
        assert nxt.request_id not in got
        return {"replayed": fleet2.metrics.journal_replayed,
                "done_before": len(done1),
                "tokens": [got[r.request_id] for r in reqs]}

    got = _both(sides, scenario)
    assert got["replayed"] > 0


# -- device faults ------------------------------------------------------------
def test_device_fault_reraises_from_fleet_step_without_restart(sides):
    """A ``torch.AcceleratorError`` from a replica step is sticky for the
    process: the port's fleet re-raises it instead of failing the replica
    over, and starts no restart (JAX's fleet contains every step error)."""
    side = sides[1]
    fleet = _fleet(side, dict(max_restarts=2))
    params = _params(side, max_new_tokens=6)
    reqs = [fleet.add_request([1, 2, 3 + i], params) for i in range(4)]
    fleet.step()

    def device_fault(_ctx):
        raise torch.AcceleratorError("CUDA error: an illegal memory access")

    spec = FaultSpec(action=device_fault,
                     when=lambda c: (c.get("phase") == "step"
                                     and c.get("replica") == "r0"))
    with faults.inject({"serving.replica": spec}):
        with pytest.raises(torch.AcceleratorError, match="illegal"):
            fleet.step()
    assert fleet.metrics.failovers == 0
    assert all(s.status == "healthy" and s.restarts == 0
               for s in fleet.replicas)
    assert fleet.replica("r0")._restart_thread is None
    assert not any(r.done for r in reqs)


def test_device_fault_in_a_restart_is_not_retried(sides):
    """A restart whose engine build raises a device fault makes one
    attempt (the retry policy retries every other error) and ``poll``
    re-raises it on the stepping thread."""
    side = sides[1]
    fleet = _fleet(side)
    attempts = []

    def build_fault(ctx):
        attempts.append(ctx["phase"])
        raise torch.AcceleratorError("CUDA error: launch failure")

    specs = {"serving.replica": [
        _kill(side, "r0", 1),
        FaultSpec(action=build_fault,
                  when=lambda c: c.get("phase") == "restart"),
    ]}
    reqs = [fleet.add_request([1, 2, 3 + i], _params(side, max_new_tokens=4))
            for i in range(4)]
    with faults.inject(specs):
        fleet.step()                     # r0 dies, its restart starts
        assert fleet.replica("r0").join_restart(10)
        with pytest.raises(torch.AcceleratorError, match="launch failure"):
            fleet.step()
    assert attempts == ["restart"]
    assert fleet.replica("r0").status == "failed"
    assert fleet.metrics.failovers == 1
    del reqs
