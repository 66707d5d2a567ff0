"""Continuous-batching LLM serving engine.

Counterpart of ``paddle_tpu/serving/engine.py``, cut to this slice: the
Orca (OSDI '22) iteration-level scheduler over a paged KV pool. The
batch is ``max_batch_slots`` slots; requests join and leave mid-flight.
Each ``step()``:

  * finishes the requests whose TTL has lapsed (``_expire``,
    ``finish_reason="timeout"``), queued or running;
  * admits waiting requests FCFS into free slots, gated on KV blocks for
    the whole prompt plus one decode write (``max_waiting`` bounds the
    queue; ``kv_shed_threshold`` sheds new requests under KV pressure
    with ``EngineOverloadedError``);
  * prefills each admitted request with one prefill program of its
    length bucket and samples its first token;
  * makes sure every running request owns a block for the token it is
    about to write, preempting the YOUNGEST running request when the
    pool is exhausted (recompute-style: its tokens are kept and a later
    prefill over ``prompt + output[:-1]`` rebuilds its cache exactly, so
    greedy outputs are unchanged by preemption);
  * runs one decode program over all slots and samples every slot at
    once.

The programs (``serving.programs``) are the JAX engine's compiled steps:
at most two decode programs (greedy and mixed, chosen by a host bool as
JAX's static ``any_sample``) and one prefill program per bucket, counted
by ``metrics.decode_compiles`` / ``prefill_compiles``. On the card each
is a CUDA graph: a step stages its inputs into one pinned host buffer,
issues one host-to-device copy, replays the decode graph and reads the
[slots] next tokens back with one device-to-host copy, the step's one
sync (JAX has it too). On the CPU the same functions run eagerly.

``EngineConfig(kv_cache_dtype="int8")`` stores the pool as int8 pages
with one f32 scale per token per kv head (``KVPool(quant_dtype=)``),
quantized on write and read by the int8 paged kernel: the greedy
byte-parity contract becomes a tolerance contract, as in the JAX
package. ``EngineConfig(decode_kernel=)`` picks decode attention
("auto"/"pallas": the paged kernel; "xla": the plain version, counted).

Sampling noise: batched decode draws from a ``torch.Generator`` seeded
with ``EngineConfig.seed`` (each replay of the mixed decode program
advances it); each prefill reseeds the prefill generator from the
engine's request stream, or, for a sampled request with
``SamplingParams(seed=)``, from ``(seed, tokens generated)``, as JAX's
``_request_key``. The KV pool is updated in place.

``submit``/``resume``/``release`` move Request objects between engines
(the fleet's migration primitive, without the spill tier); ``health()``
reports status, flags, the queue and the pool.

Not ported yet (later slices): prefix cache, chunked prefill and COW,
speculative decoding, journal, QoS, HTTP front door, fleet, tensor
parallelism, spill tier, step observatory, SLO tracking, access log,
poison isolation (it needs ``resilience/faults.py``), the watchdog, the
analysis gate and the compile cache.
"""
from __future__ import annotations

import collections
import time

import torch

from ..generation import uniform_noise
from .adapter import DECODE_KERNELS, build_adapter
from .bucketing import next_bucket
from .kv_cache import BlockManager, KVPool
from .metrics import EngineMetrics
from .programs import Program, StepBuffers
from .request import (
    Request,
    RequestOutput,
    RequestState,
    normalize_sampling_params,
)
from .sampler import pack_sampling_params, sample_tokens

__all__ = ["Engine", "EngineConfig", "EngineOverloadedError"]


class EngineOverloadedError(RuntimeError):
    """add_request rejected under KV pressure (load shedding): the
    caller should back off or route elsewhere rather than deepen an
    already-saturated queue."""


_MASK63 = (1 << 63) - 1


def _mix(a, b):
    """A 63-bit generator seed from two integers (splitmix64's
    finalizer over ``a`` and ``b``): distinct pairs give unrelated
    seeds."""
    z = (a * 0x9E3779B97F4A7C15 + b + 0x632BE59BD9B4E019) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) & _MASK63


class _Backoff:
    """``generate``'s pause while every pending prompt is shed and
    nothing is in flight: exponential from ``base`` to ``cap`` seconds."""

    def __init__(self, base=0.001, cap=0.05, sleep=time.sleep):
        self.base, self.cap, self.sleep = base, cap, sleep

    def pause(self, attempt):
        self.sleep(min(self.cap, self.base * 2.0 ** (attempt - 1)))


def _default_buckets(max_model_len):
    """Doubling ladder from 16 (or smaller) up to max_model_len."""
    buckets = []
    b = min(16, max_model_len)
    while b < max_model_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_model_len)
    return buckets


class EngineConfig:
    def __init__(self, max_batch_slots=8, max_model_len=2048, page_size=16,
                 num_blocks=None, prefill_buckets=None, max_waiting=None,
                 seed=0, kv_cache_dtype=None, kv_shed_threshold=None,
                 decode_kernel="auto"):
        if max_batch_slots < 1:
            raise ValueError("max_batch_slots must be >= 1")
        if page_size < 1 or max_model_len < 2:
            raise ValueError("need page_size >= 1 and max_model_len >= 2")
        self.max_batch_slots = int(max_batch_slots)
        self.max_model_len = int(max_model_len)
        self.page_size = int(page_size)
        self.pages_per_seq = -(-self.max_model_len // self.page_size)
        self.num_blocks = int(
            num_blocks if num_blocks is not None
            else self.max_batch_slots * self.pages_per_seq
        )
        if self.num_blocks < self.pages_per_seq:
            raise ValueError(
                f"num_blocks ({self.num_blocks}) cannot hold even one "
                f"max-length request ({self.pages_per_seq} pages)"
            )
        self.prefill_buckets = sorted(
            int(b) for b in (prefill_buckets
                             or _default_buckets(self.max_model_len))
        )
        if self.prefill_buckets[-1] < self.max_model_len:
            raise ValueError(
                "largest prefill bucket must cover max_model_len "
                f"({self.prefill_buckets[-1]} < {self.max_model_len})"
            )
        if max_waiting is not None and max_waiting < 1:
            raise ValueError(
                f"max_waiting must be >= 1 or None (unbounded), got "
                f"{max_waiting}"
            )
        self.max_waiting = max_waiting
        if kv_shed_threshold is not None and not (
                0.0 < kv_shed_threshold <= 1.0):
            raise ValueError(
                f"kv_shed_threshold must be in (0, 1] or None, got "
                f"{kv_shed_threshold}"
            )
        # shed new requests (EngineOverloadedError) while the pool's
        # utilization is at or above this fraction
        self.kv_shed_threshold = kv_shed_threshold
        if decode_kernel not in DECODE_KERNELS:
            raise ValueError(
                f'decode_kernel must be "auto", "pallas" or "xla", got '
                f"{decode_kernel!r}"
            )
        self.decode_kernel = decode_kernel
        self.seed = int(seed)
        # None stores the adapter's dtype; "int8" stores quantize-on-write
        # int8 pages plus per-token scales
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(
                f'kv_cache_dtype must be None or "int8", got '
                f"{kv_cache_dtype!r}"
            )
        self.kv_cache_dtype = kv_cache_dtype


class Engine:
    """Continuous-batching serving over one model replica, on the
    model's device.

        engine = serving.Engine(model, serving.EngineConfig(...))
        engine.add_request([1, 2, 3], serving.SamplingParams(max_new_tokens=8))
        while engine.has_unfinished():
            for out in engine.step():
                print(out.request_id, out.token_ids)
    """

    def __init__(self, model, config=None):
        self.config = cfg = config or EngineConfig()
        self.adapter = build_adapter(model)
        # decode attention lives on the adapter (the programs read it when
        # they are built): always assigned where the knob exists, so an
        # adapter reused across engines carries this engine's choice; a
        # non-default choice without the knob fails here, naming the flag
        if hasattr(self.adapter, "decode_kernel"):
            self.adapter.decode_kernel = cfg.decode_kernel
        elif cfg.decode_kernel != "auto":
            raise TypeError(
                f"{type(self.adapter).__name__} has no decode_kernel "
                f"attribute, but EngineConfig(decode_kernel="
                f"{cfg.decode_kernel!r}) needs an adapter that can select "
                "its decode attention path"
            )
        self.device = dev = torch.device(self.adapter.device)
        self.metrics = EngineMetrics()
        self.pool = KVPool(
            self.adapter.num_layers, self.adapter.num_kv_heads,
            cfg.num_blocks, cfg.page_size, self.adapter.head_dim,
            self.adapter.dtype, dev, quant_dtype=cfg.kv_cache_dtype,
        )
        self.block_manager = BlockManager(cfg.num_blocks, cfg.page_size)
        self.waiting: collections.deque = collections.deque()
        self.slots: list = [None] * cfg.max_batch_slots
        # requests aborted between steps, emitted by the next step()
        self._aborted: list = []
        self._admit_counter = 0
        self._shed_backoff = _Backoff()
        # noise: the decode stream, and the prefill generator reseeded
        # per launch from the request stream (_request_seed)
        self._generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self._prefill_generator = torch.Generator(device=dev)
        self._stream_base = _mix(cfg.seed, 0x5EED)
        self._key_counter = 0
        # static inputs: one buffer for both decode programs, one for
        # every prefill bucket (a bucket's program reads the first
        # ``bucket`` ids)
        n, pps = cfg.max_batch_slots, cfg.pages_per_seq
        sampling = [("temperature", 1, "float32"), ("top_k", 1, "int32"),
                    ("top_p", 1, "float32"), ("do_sample", 1, "int32")]
        self._decode_buffers = StepBuffers(
            [("tokens", n, "int32"), ("positions", n, "int32"),
             ("active", n, "int32"), ("tables", n * pps, "int32")]
            + [(name, n, t) for name, _, t in sampling], dev)
        self._prefill_buffers = StepBuffers(
            [("ids", cfg.prefill_buckets[-1], "int32"),
             ("length", 1, "int32"), ("table", pps, "int32")] + sampling,
            dev)
        self._decode_programs: dict = {}
        self._prefill_programs: dict = {}
        self._graph_pool = self._capture_stream = None
        if dev.type == "cuda":
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(dev)

    # -- programs ------------------------------------------------------------
    def _program(self, fn, generator):
        return Program(fn, self.device, pool=self._graph_pool,
                       stream=self._capture_stream, generators=(generator,)
                       if generator is not None else ())

    def _decode_program(self, any_sample):
        """The decode program over every slot; ``any_sample`` (a host
        bool) adds the sampling warp and the noise, as JAX's static
        flag: at most two programs exist."""
        prog = self._decode_programs.get(any_sample)
        if prog is not None:
            return prog
        f, pool, adapter = self._decode_buffers.dev, self.pool, self.adapter
        cfg, gen = self.config, self._generator
        tables = f["tables"].view(cfg.max_batch_slots, cfg.pages_per_seq)

        def decode_fn():
            logits = adapter.decode(pool.k, pool.v, f["tokens"],
                                    f["positions"], tables, f["active"] != 0)
            u = (uniform_noise(logits.shape, gen, logits.device)
                 if any_sample else None)
            nxt = sample_tokens(logits, f["temperature"], f["top_k"],
                                f["top_p"], f["do_sample"], u)
            return nxt, logits

        self._pin_adapter()
        # the build runs decode_fn once eagerly: over zeroed inputs (no
        # active slot) it writes no page
        self._decode_buffers.device.zero_()
        prog = self._program(decode_fn, gen if any_sample else None)
        self._decode_programs[any_sample] = prog
        self.metrics.decode_compiles += 1
        return prog

    def _prefill_program(self, bucket):
        """The prefill program of one length bucket: the prompt's logits
        at ``length - 1``, then its token (greedy or sampled, as the
        request's parameters say; the noise from the prefill
        generator)."""
        prog = self._prefill_programs.get(bucket)
        if prog is not None:
            return prog
        f, pool, adapter = self._prefill_buffers.dev, self.pool, self.adapter
        gen = self._prefill_generator
        ids = f["ids"][:bucket]

        def prefill_fn():
            logits = adapter.prefill(pool.k, pool.v, ids, f["length"][0],
                                     f["table"])
            u = uniform_noise((1, logits.shape[-1]), gen, logits.device)
            tok = sample_tokens(logits[None], f["temperature"], f["top_k"],
                                f["top_p"], f["do_sample"], u)
            return tok, logits

        self._pin_adapter()
        # the build runs prefill_fn once eagerly: over zeroed inputs (a
        # prompt of length 0) it writes no page
        self._prefill_buffers.device.zero_()
        prog = self._program(prefill_fn, gen)
        self._prefill_programs[bucket] = prog
        self.metrics.prefill_compiles += 1
        return prog

    def _pin_adapter(self):
        """Re-assert this engine's decode attention on a shared adapter
        before a program reads it."""
        if hasattr(self.adapter, "decode_kernel"):
            self.adapter.decode_kernel = self.config.decode_kernel

    def _request_seed(self, req):
        """The prefill generator's seed for one request's launch. The
        engine's request stream always advances (a seeded request in the
        mix never shifts the others' noise); a sampled request with
        ``SamplingParams.seed`` draws from ``(seed, tokens generated)``
        instead, so its first token does not depend on engine history."""
        self._key_counter += 1
        p = req.sampling_params
        if p.do_sample and p.seed is not None:
            return _mix(p.seed, len(req.output_token_ids))
        return _mix(self._stream_base, self._key_counter)

    @staticmethod
    def _stage_sampling(h, requests, rows):
        params = pack_sampling_params(requests)
        for name in ("temperature", "top_k", "top_p", "do_sample"):
            h[name][rows] = params[name]

    # -- client API ----------------------------------------------------------
    def add_request(self, prompt_token_ids, sampling_params=None,
                    request_id=None):
        return self.submit(
            Request(prompt_token_ids, sampling_params, request_id)
        )

    def submit(self, req):
        """Admission of a caller-constructed Request (what
        ``add_request`` wraps), so one Request object can move between
        engines: the one submitted here is what ``release`` hands back
        and another engine's ``resume`` takes."""
        cfg = self.config
        if (cfg.max_waiting is not None
                and len(self.waiting) >= cfg.max_waiting):
            raise RuntimeError(
                f"admission queue full ({cfg.max_waiting} waiting)"
            )
        if len(req.prompt_token_ids) >= cfg.max_model_len:
            raise ValueError(
                f"prompt of {len(req.prompt_token_ids)} tokens leaves no "
                f"room to generate under max_model_len={cfg.max_model_len}"
            )
        if cfg.kv_shed_threshold is not None:
            # with no prefix cache or speculation yet no block is
            # reclaimable: the pressure is the pool's utilization
            bm = self.block_manager
            util = bm.utilization()
            admissible_now = (
                not self.waiting and None in self.slots
                and bm.num_free >= bm.blocks_needed(
                    len(req.prompt_token_ids) + 1
                )
            )
            if util >= cfg.kv_shed_threshold and not admissible_now:
                self.metrics.requests_shed += 1
                raise EngineOverloadedError(
                    f"KV pool at {util:.0%} utilization (threshold "
                    f"{cfg.kv_shed_threshold:.0%}); request shed"
                )
        self.waiting.append(req)
        self.metrics.requests_received += 1
        return req

    def resume(self, req):
        """Re-enqueue a request whose KV state was lost outside this
        engine (``release`` on another engine): scheduling state is
        reset, prompt and generated tokens kept, so the next prefill
        rebuilds the cache over ``prompt + output[:-1]`` and greedy
        continuation is byte-identical. Joins the head of the queue and
        bypasses ``max_waiting`` and shedding."""
        if req.state is RequestState.FINISHED:
            raise ValueError(
                f"cannot resume finished request {req.request_id!r}"
            )
        req.block_ids = []
        req.num_cached = 0
        req.slot = None
        req.state = RequestState.WAITING
        self.waiting.appendleft(req)
        self.metrics.requests_received += 1
        return req

    def release(self, request_id):
        """Detach an unfinished request WITHOUT finishing it: its KV
        blocks and slot are freed, its state resets to WAITING with
        ``num_cached=0``, and the Request (prompt, generated tokens,
        arrival and deadline) is returned for ``resume`` on another
        engine. No finish accounting and no RequestOutput. None when the
        id is not here."""
        req = next((r for r in self.waiting if r.request_id == request_id),
                   None)
        if req is not None:
            self.waiting.remove(req)
        else:
            req = next((r for r in self.slots
                        if r is not None and r.request_id == request_id),
                       None)
        if req is None or req.state is RequestState.FINISHED:
            return None
        self._release(req)
        req.state = RequestState.WAITING
        req.num_cached = 0
        return req

    def abort(self, request_id):
        """Drop a request wherever it is; True if found. Its output
        (``finish_reason="aborted"``) is emitted by the next ``step()``."""
        for req in list(self.waiting):
            if req.request_id == request_id:
                self.waiting.remove(req)
                self._finish(req, "aborted", self._aborted)
                return True
        for req in self.slots:
            if req is not None and req.request_id == request_id:
                self._finish(req, "aborted", self._aborted)
                return True
        return False

    def has_unfinished(self):
        return bool(self._aborted) or bool(self.waiting) or any(
            r is not None for r in self.slots
        )

    def generate(self, prompts, sampling_params=None):
        """Submit everything, step until drained, return RequestOutputs in
        submission order. The queue is fed as it drains when
        ``max_waiting`` bounds it; a prompt shed under KV pressure is
        resubmitted once the batch drains (flow control: the shed count
        is undone), with a backoff while nothing is in flight."""
        params = normalize_sampling_params(prompts, sampling_params)
        cap = self.config.max_waiting
        pending = collections.deque(zip(prompts, params))
        reqs, done = [], {}
        stalls = 0
        while pending or self.has_unfinished():
            admitted = False
            while pending and (cap is None or len(self.waiting) < cap):
                p, sp = pending.popleft()
                try:
                    reqs.append(self.add_request(p, sp))
                    admitted = True
                except EngineOverloadedError:
                    self.metrics.requests_shed -= 1
                    pending.appendleft((p, sp))
                    break
            outs = self.step()
            for out in outs:
                done[out.request_id] = out
            if (pending and not admitted and not outs
                    and not self.has_unfinished()):
                stalls += 1
                self._shed_backoff.pause(stalls)
            else:
                stalls = 0
        return [done[r.request_id] for r in reqs]

    def health(self):
        """Health snapshot: ``status`` is "ok", "degraded" (requests
        expired) or "overloaded" (admission queue full, or KV pressure at
        the shedding threshold; overloaded beats degraded); ``flags``
        carries both signals. The JAX engine's watchdog, SLO, spill,
        prefix-cache (reclaimable blocks, active utilization),
        speculation and tensor-parallel fields wait for their
        modules."""
        m, bm, cfg = self.metrics, self.block_manager, self.config
        util = bm.utilization()
        queue_full = (cfg.max_waiting is not None
                      and len(self.waiting) >= cfg.max_waiting)
        shedding = (cfg.kv_shed_threshold is not None
                    and util >= cfg.kv_shed_threshold)
        degraded = bool(m.requests_timeout)
        overloaded = queue_full or shedding
        status = "ok"
        if degraded:
            status = "degraded"
        if overloaded:
            status = "overloaded"
        return {
            "status": status,
            "flags": [f for f, on in (("degraded", degraded),
                                      ("overloaded", overloaded)) if on],
            "queue_depth": len(self.waiting),
            "num_running": sum(r is not None for r in self.slots),
            "decode_kernel": cfg.decode_kernel,
            "kv_cache_dtype": cfg.kv_cache_dtype or str(
                self.pool.dtype).replace("torch.", ""),
            "kv_bytes_per_token": self.pool.bytes_per_token(),
            "kv_utilization": util,
            "kv_headroom_blocks": bm.num_free,
            "requests_timeout": m.requests_timeout,
            "requests_shed": m.requests_shed,
            "preemptions": m.preemptions,
        }

    # -- scheduler -----------------------------------------------------------
    def step(self):
        """One scheduler iteration: expire TTLs, admit and prefill
        joiners, then one decode step over the running slots. Returns
        RequestOutputs of the requests that finished in this step."""
        finished = list(self._aborted)
        self._aborted.clear()
        self._expire(finished)
        self._admit()
        self._prefill_admitted(finished)
        if self._running():
            self._ensure_capacity()
            idxs = self._running()
            if idxs:
                self._decode(idxs, finished)
        return finished

    def _expire(self, finished):
        """Finish requests (queued or running) whose TTL has lapsed, with
        ``finish_reason="timeout"``."""
        now = time.perf_counter()
        for req in [r for r in self.waiting if r.expired(now)]:
            self.waiting.remove(req)
            self.metrics.requests_timeout += 1
            self._finish(req, "timeout", finished)
        for req in list(self.slots):
            if req is not None and req.expired(now):
                self.metrics.requests_timeout += 1
                self._finish(req, "timeout", finished)

    def _running(self):
        return [
            i for i, r in enumerate(self.slots)
            if r is not None and r.state is RequestState.RUNNING
        ]

    def _admit(self):
        """FCFS admission into free slots, each with its full block
        budget (whole prompt plus one decode write)."""
        bm = self.block_manager
        while self.waiting and None in self.slots:
            req = self.waiting[0]
            n_alloc = bm.blocks_needed(len(req.tokens_to_prefill()) + 1)
            if not bm.can_allocate(n_alloc):
                break
            self.waiting.popleft()
            req.block_ids = bm.allocate(n_alloc)
            req.num_cached = 0
            req.slot = self.slots.index(None)
            self.slots[req.slot] = req
            req.state = RequestState.PREFILLING
            req.admit_seq = self._admit_counter
            self._admit_counter += 1

    def _prefill_admitted(self, finished):
        """One prefill launch per admitted request, oldest first."""
        cfg = self.config
        for req in sorted(
            (r for r in self.slots
             if r is not None and r.state is RequestState.PREFILLING),
            key=lambda r: r.admit_seq,
        ):
            self._prefill(req, req.tokens_to_prefill())
            req.state = RequestState.RUNNING
            reason = req.check_stop(cfg.max_model_len)
            if reason:
                self._finish(req, reason, finished)

    def _prefill(self, req, tokens):
        """Stage the prompt into the prefill buffer, run its bucket's
        program, read its token back."""
        cfg = self.config
        bucket = next_bucket(len(tokens), cfg.prefill_buckets)
        bufs = self._prefill_buffers
        h = bufs.np
        bufs.clear()
        h["ids"][: len(tokens)] = tokens
        h["length"][0] = len(tokens)
        h["table"][: len(req.block_ids)] = req.block_ids
        self._stage_sampling(h, [req], slice(0, 1))
        prog = self._prefill_program(bucket)
        # after the build: its warm-up draws from the generator too
        self._prefill_generator.manual_seed(self._request_seed(req))
        self._pin_adapter()
        bufs.stage()
        tok = int(prog()[0].cpu()[0])
        req.num_cached = len(tokens)
        self.metrics.prefill_tokens += len(tokens)
        self.metrics.prefill_steps += 1
        if req.output_token_ids:
            # re-prefill after preemption: the sampled token re-derives
            # output[-1]; keep the one already emitted
            req.last_token = req.output_token_ids[-1]
        else:
            req.first_token_time = time.perf_counter()
            self.metrics.record_ttft(req.first_token_time - req.arrival_time)
            req.output_token_ids.append(tok)
            req.last_token = tok

    def _ensure_capacity(self):
        """Every running request needs a block for the KV slot its next
        decode step writes; preempt the youngest on exhaustion."""
        bm = self.block_manager
        for req in sorted(
            (r for r in self.slots if r is not None),
            key=lambda r: r.admit_seq,
        ):
            if req.state is not RequestState.RUNNING:
                continue  # preempted by an older request this pass
            need = bm.blocks_needed(req.num_cached + 1)
            while len(req.block_ids) < need:
                if bm.can_allocate(1):
                    req.block_ids += bm.allocate(1)
                    continue
                victims = [
                    r for r in self.slots if r is not None and r is not req
                ]
                if not victims:
                    raise RuntimeError(
                        "KV pool exhausted by a single request; "
                        "EngineConfig.num_blocks is too small for "
                        "max_model_len"
                    )
                self._preempt(max(victims, key=lambda r: r.admit_seq))

    def _preempt(self, req):
        """Recompute-style preemption: free the blocks, keep the tokens,
        requeue at the head."""
        self._release(req)
        req.state = RequestState.WAITING
        req.num_cached = 0
        self.waiting.appendleft(req)
        self.metrics.preemptions += 1

    def _launch_decode(self, idxs):
        """Run the decode program with only ``idxs`` active: stage every
        slot's token, position, block table and sampling parameters into
        the host buffer, one copy to the device, one replay, one read-back
        of the [slots] next tokens. Slots are independent (each attends to
        its own pages)."""
        bufs = self._decode_buffers
        h = bufs.np
        bufs.clear()
        tables = h["tables"].reshape(self.config.max_batch_slots, -1)
        for i in idxs:
            req = self.slots[i]
            h["tokens"][i] = req.last_token
            h["positions"][i] = req.num_cached
            h["active"][i] = 1
            tables[i, : len(req.block_ids)] = req.block_ids
        self._stage_sampling(h, self.slots, slice(None))
        any_sample = bool(h["do_sample"][idxs].any())
        prog = self._decode_program(any_sample)
        self._pin_adapter()
        bufs.stage()
        nxt = prog()[0].cpu().numpy()
        self.metrics.decode_steps += 1
        return nxt

    def _decode(self, idxs, finished):
        """One decode step with ``idxs`` active; book each slot's token."""
        cfg = self.config
        nxt = self._launch_decode(idxs)
        for i in idxs:
            req = self.slots[i]
            req.num_cached += 1
            tok = int(nxt[i])
            req.output_token_ids.append(tok)
            req.last_token = tok
            self.metrics.decode_tokens += 1
            reason = req.check_stop(cfg.max_model_len)
            if reason:
                self._finish(req, reason, finished)

    # -- teardown ------------------------------------------------------------
    def _release(self, req):
        """Free the request's KV blocks and vacate its slot."""
        if req.block_ids:
            self.block_manager.free(req.block_ids)
            req.block_ids = []
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None

    def _finish(self, req, reason, finished):
        req.finish_reason = reason
        req.state = RequestState.FINISHED
        req.finish_time = time.perf_counter()
        self._release(req)
        self.metrics.requests_finished += 1
        finished.append(RequestOutput(req))
