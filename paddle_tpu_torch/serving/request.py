"""Request lifecycle for the serving engine.

Counterpart of ``paddle_tpu/serving/request.py``: per-request sampling
params (with the TTL and the sampling seed, and the journal's
``to_dict``/``from_dict``), token accounting, deadlines and stop
conditions, the tenant and trace id a request carries, and its
``RequestTimeline`` (phase stamps and counters, surfaced on
``RequestOutput.metrics``, the access log and the latency digests), the
goodput ledger's ``resume_cause`` and the spill tier's handle
(``spill_key``, ``spill_tokens``). Stop semantics mirror ``generate``:
the stop token itself is kept in the output.
"""
from __future__ import annotations

import enum
import itertools
import time

from ..observability.spans import current_trace_id

__all__ = ["RequestState", "SamplingParams", "Request", "RequestOutput",
           "RequestTimeline", "normalize_sampling_params"]


def normalize_sampling_params(prompts, sampling_params):
    """One params-per-prompt list from a single SamplingParams
    (broadcast) or a per-prompt list."""
    if isinstance(sampling_params, (list, tuple)):
        if len(sampling_params) != len(prompts):
            raise ValueError("one SamplingParams per prompt required")
        return list(sampling_params)
    return [sampling_params] * len(prompts)


class RequestState(enum.Enum):
    WAITING = 0     # queued (never scheduled, or preempted back to queue)
    RUNNING = 1     # owns a batch slot + KV blocks, decoding
    FINISHED = 2
    PREFILLING = 3  # owns a slot + blocks, prompt not prefilled yet


def _check_int(field, value, allow_none=False):
    if value is None and allow_none:
        return None
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(
            f"{field} must be an integer, got "
            f"{type(value).__name__}: {value!r}"
        )
    return int(value)


def _check_float(field, value, allow_none=False):
    if value is None and allow_none:
        return None
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(
            f"{field} must be a number, got "
            f"{type(value).__name__}: {value!r}"
        )
    return float(value)


class SamplingParams:
    """Per-request sampling knobs (greedy unless ``do_sample``; warps are
    temperature -> top-k -> top-p). ``ttl_s``: a wall-clock budget from
    arrival, after which the engine finishes the request with
    ``finish_reason="timeout"``, queued or running. ``seed``: on a
    sampled request, its single-request launch (the prefill) draws its
    noise from ``(seed, tokens generated so far)`` instead of the
    engine's stream, so its first token does not depend on engine
    history; batched decode keeps the engine's per-step stream, as in
    JAX."""

    def __init__(self, max_new_tokens=16, do_sample=False, temperature=1.0,
                 top_k=0, top_p=1.0, eos_token_id=None, stop_token_ids=(),
                 ttl_s=None, seed=None):
        max_new_tokens = _check_int("max_new_tokens", max_new_tokens)
        temperature = _check_float("temperature", temperature)
        top_k = _check_int("top_k", top_k)
        top_p = _check_float("top_p", top_p)
        eos_token_id = _check_int("eos_token_id", eos_token_id,
                                  allow_none=True)
        ttl_s = _check_float("ttl_s", ttl_s, allow_none=True)
        seed = _check_int("seed", seed, allow_none=True)
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if temperature <= 0.0:
            raise ValueError(
                f"temperature must be > 0 (got {temperature}); use "
                "do_sample=False for greedy decoding"
            )
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got {top_k}")
        if isinstance(stop_token_ids, (str, bytes)) or not hasattr(
                stop_token_ids, "__iter__"):
            raise ValueError(
                "stop_token_ids must be a sequence of integers, got "
                f"{type(stop_token_ids).__name__}: {stop_token_ids!r}"
            )
        self.max_new_tokens = max_new_tokens
        self.do_sample = bool(do_sample)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        self.stop_token_ids = tuple(
            _check_int("stop_token_ids", t) for t in stop_token_ids
        )
        if ttl_s is not None and ttl_s < 0:
            raise ValueError(f"ttl_s must be >= 0 or None, got {ttl_s}")
        self.ttl_s = ttl_s
        self.seed = seed

    @property
    def stop_ids(self):
        """The full stop set: explicit stop tokens plus EOS."""
        ids = set(self.stop_token_ids)
        if self.eos_token_id is not None:
            ids.add(int(self.eos_token_id))
        return ids

    def to_dict(self):
        """JSON-able form (the request journal's ADMIT payload, the same
        keys as the JAX package's)."""
        return {
            "max_new_tokens": self.max_new_tokens,
            "do_sample": self.do_sample,
            "temperature": self.temperature,
            "top_k": self.top_k,
            "top_p": self.top_p,
            "eos_token_id": self.eos_token_id,
            "stop_token_ids": list(self.stop_token_ids),
            "ttl_s": self.ttl_s,
            "seed": self.seed,
        }

    @classmethod
    def from_dict(cls, d):
        """Inverse of :meth:`to_dict`. Unknown keys are ignored so a
        journal written by a newer build still replays."""
        known = (
            "max_new_tokens", "do_sample", "temperature", "top_k",
            "top_p", "eos_token_id", "stop_token_ids", "ttl_s", "seed",
        )
        return cls(**{k: d[k] for k in known if k in d})


class RequestTimeline:
    """Per-request lifecycle record: monotonic phase stamps plus the
    event counters that explain a tail sample (chunks, prefix-cache
    tokens, speculation, preemptions). Plain attributes bumped host-side
    by the engine. Surfaced on ``RequestOutput.metrics`` and fed into
    the engine's latency digests at finish.

    Phase definitions (all from ``arrival``, ``time.perf_counter``):

      queue_wait  arrival -> first slot assignment (``admitted``)
      ttft        arrival -> first generated token
      e2e         arrival -> finish
      tpot        (finish - first token) / (output_tokens - 1), the
                  steady-state inter-token latency (None for
                  single-token outputs)
    """

    __slots__ = (
        "arrival", "admitted", "first_token", "finish", "finish_reason",
        "prefill_chunks", "prefill_tokens", "prefix_hit_tokens",
        "decode_tokens", "verify_steps", "spec_accepted", "preemptions",
        "resumes", "hops", "recovered",
    )

    def __init__(self, arrival):
        self.arrival = arrival      # perf_counter at Request creation
        self.admitted = None        # first slot assignment
        self.first_token = None
        self.finish = None
        self.finish_reason = None
        self.prefill_chunks = 0     # prefill launches (1 = one-shot)
        self.prefill_tokens = 0     # tokens actually computed
        self.prefix_hit_tokens = 0  # prompt tokens served from cache
        self.decode_tokens = 0      # tokens emitted by decode/verify
        self.verify_steps = 0       # speculative verify launches
        self.spec_accepted = 0      # draft tokens accepted
        self.preemptions = 0        # KV-pressure recompute preemptions
        self.resumes = 0            # external resume() calls
        self.hops = []              # engine ids that admitted it
        self.recovered = False      # re-admitted from the journal

    def mark_admitted(self, engine_id, now=None):
        if now is None:
            now = time.perf_counter()
        if self.admitted is None:
            self.admitted = now
        if not self.hops or self.hops[-1] != engine_id:
            self.hops.append(engine_id)
        return now

    def mark_finish(self, reason, now=None):
        self.finish = now if now is not None else time.perf_counter()
        self.finish_reason = reason
        return self.finish

    # -- derived phases (None until the transition happened) ---------------
    @property
    def queue_wait_s(self):
        return (self.admitted - self.arrival
                if self.admitted is not None else None)

    @property
    def ttft_s(self):
        return (self.first_token - self.arrival
                if self.first_token is not None else None)

    @property
    def e2e_s(self):
        return self.finish - self.arrival if self.finish is not None else None

    def tpot_s(self, n_output_tokens):
        if (self.finish is None or self.first_token is None
                or n_output_tokens < 2):
            return None
        return (self.finish - self.first_token) / (n_output_tokens - 1)

    def snapshot(self, n_output_tokens=0):
        """JSON-friendly phase breakdown: the access-log line body, the
        flight-recorder timeline entry and ``RequestOutput.metrics``."""
        return {
            "queue_wait_s": self.queue_wait_s,
            "ttft_s": self.ttft_s,
            "tpot_s": self.tpot_s(n_output_tokens),
            "e2e_s": self.e2e_s,
            "finish_reason": self.finish_reason,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "decode_tokens": self.decode_tokens,
            "verify_steps": self.verify_steps,
            "spec_accepted": self.spec_accepted,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "hops": list(self.hops),
            "recovered": self.recovered,
        }


_request_counter = itertools.count()


class Request:
    """One in-flight generation. KV invariant while RUNNING: the cache
    holds ``num_cached`` tokens = prompt + all generated tokens EXCEPT
    ``last_token`` (written by the decode step that consumes it).
    Preemption frees the blocks but keeps the tokens, so a re-prefill
    over ``prompt + output[:-1]`` restores the cache exactly."""

    def __init__(self, prompt_token_ids, sampling_params=None,
                 request_id=None):
        prompt_token_ids = [int(t) for t in prompt_token_ids]
        if not prompt_token_ids:
            raise ValueError("prompt_token_ids must be non-empty")
        self.request_id = (
            request_id if request_id is not None
            else next(_request_counter)
        )
        self.prompt_token_ids = prompt_token_ids
        self.sampling_params = sampling_params or SamplingParams()
        self.state = RequestState.WAITING
        self.output_token_ids: list = []
        self.finish_reason = None
        self.error = None         # "ExcType: msg" when finish_reason="error"
        # scheduling fields (engine-owned while in a slot)
        self.block_ids: list = []
        self.num_cached = 0
        self.last_token = None
        self.slot = None
        self.admit_seq = -1       # admission order, for preemption policy
        # output tokens already written to the request journal (the emit
        # cursor; journal.admit/emit own it)
        self.journal_cursor = 0
        # goodput attribution for a forced re-prefill: "preempt"
        # (in-engine recompute preemption), "migration" (a resume after a
        # release on another engine, fleet failover or scale-down), or
        # "restored" (KV written back from the host spill tier: counted
        # useful, not wasted); the step observatory's ledger classifies
        # the recomputed tokens by it
        self.resume_cause = None
        # host spill tier handle (serving/spill.py): set when this
        # request's KV blocks were parked in host memory at preemption or
        # release; re-admission restores them instead of re-prefilling.
        # Journaled in ADMIT ("kv") so a crash replay re-anchors it
        self.spill_key = None
        self.spill_tokens = 0
        # the tier that took the handle: held while the request lives, so
        # a handle parked by ``release`` on an engine the fleet then drops
        # stays restorable by the engine that resumes the request
        self.spill_tier = None
        # QoS tenant (serving/qos.py); None for in-process callers.
        # Journaled in ADMIT ("tn") so a replay restores its accounting
        self.tenant = None
        self.arrival_time = time.perf_counter()
        self.first_token_time = None
        self.finish_time = None
        # phase stamps and counters; journal replay re-anchors .arrival
        # at the journaled wall-clock arrival
        self.timeline = RequestTimeline(self.arrival_time)
        # trace attribution captured at CREATION, on the submitting
        # thread: at finish the stepping thread's ambient span belongs
        # to no client
        self.trace_id = current_trace_id()
        self.deadline = (
            self.arrival_time + self.sampling_params.ttl_s
            if self.sampling_params.ttl_s is not None else None
        )

    def expired(self, now=None):
        return self.deadline is not None and (
            now if now is not None else time.perf_counter()
        ) >= self.deadline

    @property
    def num_tokens(self):
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    def tokens_to_prefill(self):
        """Tokens whose KV must be (re)built by a prefill: the prompt plus
        every generated token except the newest."""
        return self.prompt_token_ids + self.output_token_ids[:-1]

    def check_stop(self, max_model_len):
        """A finish reason for the current state, or None (stop token
        beats length when both trigger on the same token)."""
        p = self.sampling_params
        if self.output_token_ids and (
            self.output_token_ids[-1] in p.stop_ids
        ):
            return "stop"
        if len(self.output_token_ids) >= p.max_new_tokens:
            return "length"
        if self.num_tokens >= max_model_len:
            return "length"
        return None


class RequestOutput:
    """Immutable result handed back by the engine."""

    def __init__(self, request):
        self.request_id = request.request_id
        self.prompt_token_ids = list(request.prompt_token_ids)
        self.token_ids = list(request.output_token_ids)
        self.finish_reason = request.finish_reason
        self.error = request.error
        self.time_to_first_token = (
            request.first_token_time - request.arrival_time
            if request.first_token_time is not None else None
        )
        self.latency = (
            request.finish_time - request.arrival_time
            if request.finish_time is not None else None
        )
        # phase breakdown + lifecycle counters (the per-request view the
        # latency digests aggregate)
        self.metrics = request.timeline.snapshot(
            len(request.output_token_ids)
        )

    def __repr__(self):
        return (
            f"RequestOutput(id={self.request_id}, "
            f"n_out={len(self.token_ids)}, reason={self.finish_reason!r})"
        )
