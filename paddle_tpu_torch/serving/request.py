"""Request lifecycle for the serving engine.

Counterpart of ``paddle_tpu/serving/request.py``, cut to what this slice
of the port runs: per-request sampling params (with the TTL and the
sampling seed), token accounting, deadlines and stop conditions. The
journal's ``to_dict``/``from_dict``, tenants and timelines wait for their
slices. Stop semantics mirror ``generate``: the stop token itself is
kept in the output.
"""
from __future__ import annotations

import enum
import itertools
import time

__all__ = ["RequestState", "SamplingParams", "Request", "RequestOutput",
           "normalize_sampling_params"]


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
        # scheduling fields (engine-owned while in a slot)
        self.block_ids: list = []
        self.num_cached = 0
        self.last_token = None
        self.slot = None
        self.admit_seq = -1       # admission order, for preemption policy
        self.arrival_time = time.perf_counter()
        self.first_token_time = None
        self.finish_time = None
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
        self.time_to_first_token = (
            request.first_token_time - request.arrival_time
            if request.first_token_time is not None else None
        )
        self.latency = (
            request.finish_time - request.arrival_time
            if request.finish_time is not None else None
        )

    def __repr__(self):
        return (
            f"RequestOutput(id={self.request_id}, "
            f"n_out={len(self.token_ids)}, reason={self.finish_reason!r})"
        )
