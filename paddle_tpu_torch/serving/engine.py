"""Continuous-batching LLM serving engine.

Counterpart of ``paddle_tpu/serving/engine.py``, cut to this slice: the
Orca (OSDI '22) iteration-level scheduler over a paged KV pool. The
batch is ``max_batch_slots`` slots; requests join and leave mid-flight.
Each ``step()``:

  * admits waiting requests FCFS into free slots, gated on KV blocks for
    the whole prompt plus one decode write (``max_waiting`` bounds the
    queue);
  * prefills each admitted request in one launch (``adapter.prefill``,
    the prompt padded to a length bucket) and samples its first token;
  * makes sure every running request owns a block for the token it is
    about to write, preempting the YOUNGEST running request when the
    pool is exhausted (recompute-style: its tokens are kept and a later
    prefill over ``prompt + output[:-1]`` rebuilds its cache exactly, so
    greedy outputs are unchanged by preemption);
  * runs one decode step over all slots (``adapter.decode``, the paged
    decode kernel on the card) and samples every slot at once
    (``sampler.sample_tokens``).

``EngineConfig(kv_cache_dtype="int8")`` stores the pool as int8 pages
with one f32 scale per token per kv head (``KVPool(quant_dtype=)``),
quantized on write and read by the int8 paged kernel: the greedy
byte-parity contract becomes a tolerance contract, as in the JAX
package.

PyTorch runs eagerly: there is no ``jit``, no donation and no compile
probe; the KV pool is updated in place. Sampling noise comes from a
``torch.Generator`` seeded with ``EngineConfig.seed``.

Not ported yet (later slices): prefix cache, chunked prefill and COW,
speculative decoding, journal, QoS and load shedding,
HTTP front door, fleet, tensor parallelism, spill tier, step
observatory, SLO tracking and request TTLs, access log, poison
isolation, ``resume``/``release``, per-request sampling seeds, the
analysis gate and the compile cache.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..generation import uniform_noise
from .adapter import build_adapter
from .bucketing import next_bucket
from .kv_cache import BlockManager, KVPool
from .metrics import EngineMetrics
from .request import (
    Request,
    RequestOutput,
    RequestState,
    normalize_sampling_params,
)
from .sampler import pack_sampling_params, sample_tokens

__all__ = ["Engine", "EngineConfig"]


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
                 seed=0, kv_cache_dtype=None):
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
        self.device = torch.device(self.adapter.device)
        self.metrics = EngineMetrics()
        self.pool = KVPool(
            self.adapter.num_layers, self.adapter.num_kv_heads,
            cfg.num_blocks, cfg.page_size, self.adapter.head_dim,
            self.adapter.dtype, self.device,
            quant_dtype=cfg.kv_cache_dtype,
        )
        self.block_manager = BlockManager(cfg.num_blocks, cfg.page_size)
        self.waiting: collections.deque = collections.deque()
        self.slots: list = [None] * cfg.max_batch_slots
        # requests aborted between steps, emitted by the next step()
        self._aborted: list = []
        self._admit_counter = 0
        self._generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed
        )

    # -- client API ----------------------------------------------------------
    def add_request(self, prompt_token_ids, sampling_params=None,
                    request_id=None):
        req = Request(prompt_token_ids, sampling_params, request_id)
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
        self.waiting.append(req)
        self.metrics.requests_received += 1
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
        ``max_waiting`` bounds it."""
        params = normalize_sampling_params(prompts, sampling_params)
        cap = self.config.max_waiting
        pending = collections.deque(zip(prompts, params))
        reqs, done = [], {}
        while pending or self.has_unfinished():
            while pending and (cap is None or len(self.waiting) < cap):
                p, sp = pending.popleft()
                reqs.append(self.add_request(p, sp))
            for out in self.step():
                done[out.request_id] = out
        return [done[r.request_id] for r in reqs]

    # -- scheduler -----------------------------------------------------------
    def step(self):
        """One scheduler iteration: admit and prefill joiners, then one
        decode step over the running slots. Returns RequestOutputs of the
        requests that finished in this step."""
        finished = list(self._aborted)
        self._aborted.clear()
        self._admit()
        self._prefill_admitted(finished)
        if self._running():
            self._ensure_capacity()
            idxs = self._running()
            if idxs:
                self._decode(idxs, finished)
        return finished

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

    def _table(self, req):
        table = np.zeros(self.config.pages_per_seq, np.int32)
        table[: len(req.block_ids)] = req.block_ids
        return table

    def _prefill(self, req, tokens):
        cfg, dev = self.config, self.device
        bucket = next_bucket(len(tokens), cfg.prefill_buckets)
        ids = np.zeros(bucket, np.int64)
        ids[: len(tokens)] = tokens
        logits = self.adapter.prefill(
            self.pool.k, self.pool.v, torch.from_numpy(ids).to(dev),
            len(tokens), torch.from_numpy(self._table(req)).to(dev),
        )
        u = None
        if req.sampling_params.do_sample:
            u = uniform_noise((1, logits.shape[-1]), self._generator, dev)
        params = {k: torch.from_numpy(v).to(dev)
                  for k, v in pack_sampling_params([req]).items()}
        tok = int(sample_tokens(
            logits[None], params["temperature"], params["top_k"],
            params["top_p"], params["do_sample"], u,
        )[0])
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

    def _decode(self, idxs, finished):
        """One decode step with ``idxs`` active; every slot occupant is
        independent of the others (each attends to its own pages)."""
        cfg, dev = self.config, self.device
        n = cfg.max_batch_slots
        tokens = np.zeros(n, np.int64)
        positions = np.zeros(n, np.int64)
        tables = np.zeros((n, cfg.pages_per_seq), np.int32)
        active = np.zeros(n, bool)
        for i in idxs:
            req = self.slots[i]
            tokens[i] = req.last_token
            positions[i] = req.num_cached
            tables[i] = self._table(req)
            active[i] = True
        logits = self.adapter.decode(
            self.pool.k, self.pool.v, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(positions).to(dev),
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(active).to(dev),
        )
        params = pack_sampling_params(self.slots)
        u = None
        if params["do_sample"][idxs].any():
            u = uniform_noise(logits.shape, self._generator, dev)
        params = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        nxt = sample_tokens(
            logits, params["temperature"], params["top_k"], params["top_p"],
            params["do_sample"], u,
        ).cpu().numpy()
        self.metrics.decode_steps += 1
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
