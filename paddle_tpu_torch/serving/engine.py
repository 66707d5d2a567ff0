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
    with ``EngineOverloadedError``); with the prefix cache on, a prompt
    whose leading full blocks are cached forks them instead of
    allocating, and copies (copy-on-write) the last one when the
    one-token-to-prefill cap cuts into it;
  * prefills each admitted request: one prefill program of its length
    bucket when nothing is cached and the prompt fits one chunk, else
    continuation launches (``prefill_ext``) of at most
    ``prefill_chunk_tokens`` tokens each, at most
    ``max_prefill_chunks_per_step`` of them a step, so a long prompt
    never stalls the decode batch; the final one samples the first
    token;
  * makes sure every running request owns a block for the token it is
    about to write, preempting the YOUNGEST running request when the
    pool is exhausted (recompute-style: its tokens are kept and a later
    prefill over ``prompt + output[:-1]`` rebuilds its cache exactly, so
    greedy outputs are unchanged by preemption);
  * runs one decode program over all slots and samples every slot at
    once; with speculative decoding (``speculate_tokens=K``) the greedy
    slots first draft up to K tokens each by prompt lookup
    (``serving.speculation``), and when any slot drafted, one verify
    program scores every greedy slot's K+1-token window (its pending
    token and its draft) and each accepts the longest draft prefix that
    matches the model's own argmax, emitting the accepted tokens and the
    one after them; the sampled slots then take the decode program. A
    step where nothing was drafted runs the plain decode over every
    slot. Greedy outputs are the plain decode's either way.

The programs (``serving.programs``) are the JAX engine's compiled steps:
at most two decode programs (greedy and mixed, chosen by a host bool as
JAX's static ``any_sample``), one prefill program per bucket, one
continuation program per bucket, one copy-on-write program and one
verify program, counted by ``metrics.decode_compiles`` /
``prefill_compiles`` / ``prefill_ext_compiles`` / ``cow_compiles`` /
``verify_compiles``. On the card each
is a CUDA graph: a step stages its inputs into one pinned host buffer,
issues one host-to-device copy, replays the decode graph and reads the
[slots] next tokens back with one device-to-host copy, the step's one
sync (JAX has it too); a verify step does the same with the [slots,
K+1] argmax targets. On the CPU the same functions run eagerly.

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
``_request_key`` (every chunk launch reseeds it the same way; only the
final chunk's token is kept, non-final chunks are greedy). The KV pool
is updated in place.

``submit``/``resume``/``release`` move Request objects between engines
(the fleet's migration primitive; with the spill tier a released
request's KV rides along, see below); ``health()`` reports status,
flags, the queue, the pool, the spill tier and the step observatory.
Cached prefix blocks no
running request holds are reclaimable: they are freed before an
admission waits or a request is preempted, and they are not pressure
for ``kv_shed_threshold`` or ``health()``.

Speculative draft headroom: a greedy running slot grabs blocks for its
next window while the pool has free ones, never by preempting or
reclaiming; that headroom is reclaimable like cached prefix blocks (freed
before an admission waits, before a preemption, and not counted as
pressure).

Durability and observability (the JAX engine's hooks):
``EngineConfig(journal=)`` write-ahead logs every admission, the tokens
of each step and every finish (``serving.journal``), and an engine built
on a journal directory replays it before its first step: the unfinished
requests join the head of the queue through ``resume``'s re-prefill, and
the request-id counter moves past the journaled ids.
``EngineConfig(access_log=)`` writes one JSONL line per finished request
(``serving.access_log``); ``EngineConfig(slo=)`` tracks the windowed
TTFT/TPOT error-budget burn behind ``health()["slo_burn_rates"]`` and
its ``slo_burn`` flag. Every request carries a ``RequestTimeline``
(queue wait, TTFT, prefill chunks, preemptions, resumes, speculation),
fed into the per-phase latency digests that ``/metrics`` exports; the
engine registers its ``health()`` for ``/healthz``. The HTTP front door
over an engine is ``serving.server``.

Poison isolation (the JAX engine's ``_poison``/``_isolate``): a
prefill, chunk or copy-on-write that raises finishes its own request
with ``"error"``; a decode or verify launch that raises is retried over
subsets of its active mask (one request named by the exception's
``request_id``, else halves, down to the one that fails), each subset a
replay of the same captured program with another staged ``active``
mask. ``metrics.requests_errored``/``last_error`` count them and
``health()`` turns "degraded". A ``torch.AcceleratorError`` is never
contained: a CUDA error is sticky for the process, so it re-raises at
once. The ``serving.step`` fault site fires on the host before each
launch's staging copy. Anything that escapes ``step()`` is flight-
recorded with the engine's health probe, then re-raised. A
``serving.Fleet`` of engines (``serving/fleet.py``) supervises replicas
above this.

Step observatory (``EngineConfig(stepstats=True, stepstats_ring=256)``,
``observability/stepstats.py``): each launch's host wall (to its
read-back where it has one: no sync and no launch is added), per-program
digests, host overhead, the goodput ledger (useful, spec_reject,
preempt_recompute, migration_reprefill, aborted; classified by
``Request.resume_cause``) and MFU, one sample a non-idle step into the
flight recorder's step ring; a crashing sampler (the ``obs.stepstats``
site) warns once and disables itself. Every program capture is logged
(``observability/jit_events.py``).

Host spill tier (``EngineConfig(host_spill_bytes=, spill_dir=)``,
``serving/spill.py``): preemption and ``release`` park the victim's
cached blocks in host memory (a pinned slab allocated at build) as one
handle, and its re-admission writes them back instead of re-prefilling
(a partial handle continues through the ``prefill_ext`` program); prefix
chains evicted from the cache are demoted there and restored by a later
match; ``spill_dir`` adds a disk tier that a fresh process (journal
replay) restores from. The ``kv.spill``/``kv.restore`` sites degrade to
recompute; a ``torch.AcceleratorError`` re-raises. A pool too large for
the card is refused as ``EngineOverloadedError``, its partial
allocation released.

Static analysis (``paddle_tpu_torch.analysis``, JAX's gates):
``EngineConfig(analysis_check="warn"|"error", device_memory_budget=)``
runs the gates at build, before the KV pool or any step buffer is
allocated, over fake tensors (a fake pool, fake step buffers, the real
weights converted as the programs reach them; nothing is captured,
launched or allocated, and no capture counter moves). The memory gate
traces every program of the family (``_program_tags``), predicts each
one's per-device peak (``metrics.program_bytes``, exported as
``paddle_tpu_serving_program_bytes{program=}``; ``health()``'s
``predicted_peak_bytes_per_chip``) and refuses a config that exceeds the
budget with an ``AnalysisError`` naming the program and the budget.
``check_programs`` (and its ``check_decode``/``check_prefill``/
``check_verify`` slices) holds the programs to zero host-sync, capture
hazard (``retrace-hazard``) and ``dtype-drift`` findings.

Compile cache (``EngineConfig(compile_cache=)``, a directory or a
``compilecache.CompileCache``; JAX's ``_warm_from_cache``): the service
key (the weights' shapes, the pool, the config fields that shape a
program, the adapter's code identity and the kernel libraries' digests)
names a warmup manifest, and every program of the family
(``_program_tags``) has one artifact holding its analysis reports (the
L3 summary and the L1 findings). A build reads them before the gates
(one ``aot-hit`` a program), so a warm gated build runs no analysis
trace: the memory gate and the blocking rules re-evaluate over the
stored reports. A missing or damaged artifact costs that program a
trace, counted and warned. With a cache the engine captures every
program of the family at build, before the first request, cold and warm
alike. A captured CUDA graph cannot be serialized, so the port's warm
start still captures every program: what it skips is the fake-tensor
analysis, not the capture.

Not ported yet (later slices): tensor parallelism and placement (the
``tp_*`` fields of ``health()`` report one card) and the comm watchdog
(``health()["watchdog"]`` reports it disabled).
"""
from __future__ import annotations

import collections
import itertools
import time
import warnings
import weakref

import torch

from ..generation import uniform_noise
from ..jit.bucketing import next_bucket
from ..observability import flight as _flight
from ..observability import jit_events
from ..observability import (
    register_health_provider,
    unregister_health_provider,
)
from ..observability.latency import SLOConfig, SLOTracker
from ..observability.stepstats import StepStats, register_stepstats_view
from ..resilience import faults
from . import speculation
from .access_log import record_finish, resolve_access_log
from .adapter import DECODE_KERNELS, build_adapter
from .kv_cache import BlockManager, KVPool
from .metrics import EngineMetrics
from .prefix_cache import PrefixCache
from .programs import Program, StepBuffers, capture_lock
from .request import (
    Request,
    RequestOutput,
    RequestState,
    normalize_sampling_params,
)
from .sampler import pack_sampling_params, sample_tokens
from .spill import (
    HostSpillTier,
    PinnedSlab,
    drop_handle,
    is_resource_exhausted,
    register_spill_view,
)

__all__ = ["Engine", "EngineConfig", "EngineOverloadedError"]


class EngineOverloadedError(RuntimeError):
    """add_request rejected under KV pressure (load shedding): the
    caller should back off or route elsewhere rather than deepen an
    already-saturated queue."""


_MASK63 = (1 << 63) - 1

# failures a launch can raise that poison isolation must not contain: a
# CUDA error is sticky for the process (every later launch fails too), so
# bisecting or retrying past it would only hide it
_DEVICE_FAULTS = (torch.AcceleratorError,)

# level-1 rules that block a serving program at the analysis gate: a CUDA
# graph replays whatever its capture froze (a host sync fails the capture,
# a frozen Python scalar or a widened dtype is replayed every step)
_BLOCKING_RULES = ("host-sync", "retrace-hazard", "dtype-drift")
# what each level-1 gate protects, for its refusal
_INVARIANTS = {
    "check_decode": "decode step (the one-capture decode invariant)",
    "check_prefill": "prefill programs (the chunked-prefill latency "
                     "invariant)",
    "check_verify": "verify step (the speculative-decode latency "
                    "invariant)",
}

# monotonic engine ids (labels of the registry views and the health
# provider): id(self) is reused after an engine is collected
_engine_counter = itertools.count(1)


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


def _finding_dict(f):
    """An L1 finding as JSON-able data (the compile cache's report)."""
    return {"rule": f.rule, "severity": int(f.severity),
            "message": f.message, "file": f.file, "line": f.line,
            "op": f.op, "root": f.root}


def _finding(d):
    """``_finding_dict``'s inverse."""
    from ..analysis import Finding, Severity

    return Finding(**dict(d, severity=Severity(d["severity"])))


class EngineConfig:
    def __init__(self, max_batch_slots=8, max_model_len=2048, page_size=16,
                 num_blocks=None, prefill_buckets=None, max_waiting=None,
                 seed=0, kv_cache_dtype=None, kv_shed_threshold=None,
                 decode_kernel="auto", enable_prefix_cache=False,
                 prefix_cache_blocks=None, prefill_chunk_tokens=None,
                 max_prefill_chunks_per_step=1, speculate_tokens=None,
                 speculate_ngram=3, journal=None, access_log=None,
                 slo=None, stepstats=True, stepstats_ring=256,
                 host_spill_bytes=None, spill_dir=None, analysis_check=None,
                 device_memory_budget=None, compile_cache=None):
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
        # automatic prefix caching (serving/prefix_cache.py): share
        # read-only prompt blocks across requests, retain them after
        # release under an LRU budget of prefix_cache_blocks entries
        # (None: the whole pool is eligible)
        self.enable_prefix_cache = bool(enable_prefix_cache)
        if prefix_cache_blocks is not None and prefix_cache_blocks < 1:
            raise ValueError(
                f"prefix_cache_blocks must be >= 1 or None, got "
                f"{prefix_cache_blocks}"
            )
        self.prefix_cache_blocks = (
            int(prefix_cache_blocks) if prefix_cache_blocks is not None
            else self.num_blocks
        )
        # chunked prefill: None prefills a prompt in one launch; an int
        # splits the remaining prompt into chunks of that many tokens,
        # each padded through the prefill bucket set
        if prefill_chunk_tokens is not None:
            if prefill_chunk_tokens < 1:
                raise ValueError(
                    f"prefill_chunk_tokens must be >= 1 or None, got "
                    f"{prefill_chunk_tokens}"
                )
            if prefill_chunk_tokens > self.prefill_buckets[-1]:
                raise ValueError(
                    f"prefill_chunk_tokens ({prefill_chunk_tokens}) "
                    f"exceeds the largest prefill bucket "
                    f"({self.prefill_buckets[-1]})"
                )
        self.prefill_chunk_tokens = (
            None if prefill_chunk_tokens is None
            else int(prefill_chunk_tokens)
        )
        if max_prefill_chunks_per_step < 1:
            raise ValueError(
                f"max_prefill_chunks_per_step must be >= 1, got "
                f"{max_prefill_chunks_per_step}"
            )
        self.max_prefill_chunks_per_step = int(max_prefill_chunks_per_step)
        # speculative decoding: None disables it; an int K routes greedy
        # slots through the verify program (up to K prompt-lookup draft
        # tokens scored beside the pending token in one launch, the
        # longest prefix matching the model's argmax accepted). Sampled
        # slots keep the plain decode path.
        if speculate_tokens is not None:
            if speculate_tokens < 1:
                raise ValueError(
                    f"speculate_tokens must be >= 1 or None (disabled), "
                    f"got {speculate_tokens}"
                )
            if speculate_tokens >= self.max_model_len:
                raise ValueError(
                    f"speculate_tokens ({speculate_tokens}) must be "
                    f"smaller than max_model_len ({self.max_model_len})"
                )
        self.speculate_tokens = (
            None if speculate_tokens is None else int(speculate_tokens)
        )
        if speculate_ngram < 1:
            raise ValueError(
                f"speculate_ngram must be >= 1, got {speculate_ngram}"
            )
        # longest trailing n-gram the prompt-lookup drafter matches on
        self.speculate_ngram = int(speculate_ngram)
        # durable request journal (serving/journal.py): a directory path
        # or a Journal. Every admission, step's tokens and finish is
        # WAL-logged, and an engine built on the directory replays it
        # before its first step
        self.journal = journal
        # JSONL access log (serving/access_log.py): a directory path or
        # an AccessLog; one line per finished request
        self.access_log = access_log
        # latency SLO: windowed TTFT/TPOT error-budget burn; sustained
        # burn flips health()["flags"] (and /healthz) to degraded
        if slo is not None and not isinstance(slo, SLOConfig):
            raise TypeError(
                f"slo must be an observability.SLOConfig or None, got "
                f"{type(slo).__name__}"
            )
        self.slo = slo
        # serving step observatory (observability/stepstats.py): every
        # step folds into per-program launch-wall digests, a goodput
        # ledger, and a bounded ring of the last ``stepstats_ring``
        # non-idle steps; stepstats=False removes the sampler entirely
        self.stepstats = bool(stepstats)
        stepstats_ring = int(stepstats_ring)
        if stepstats_ring < 1:
            raise ValueError(
                f"stepstats_ring must be >= 1, got {stepstats_ring}"
            )
        self.stepstats_ring = stepstats_ring
        # host KV spill tier (serving/spill.py): preemption/release and
        # prefix-cache eviction demote KV blocks to a host LRU of this
        # many bytes (restored instead of recomputed); spill_dir adds the
        # disk tier under it
        if host_spill_bytes is not None:
            host_spill_bytes = int(host_spill_bytes)
            if host_spill_bytes < 1:
                raise ValueError(
                    f"host_spill_bytes must be >= 1 byte or None, got "
                    f"{host_spill_bytes}"
                )
        self.host_spill_bytes = host_spill_bytes
        if spill_dir is not None and host_spill_bytes is None:
            raise ValueError(
                "EngineConfig(spill_dir=) is the DISK tier under the "
                "host spill tier: set host_spill_bytes= too"
            )
        self.spill_dir = str(spill_dir) if spill_dir is not None else None
        if analysis_check not in (None, "warn", "error"):
            raise ValueError(
                'analysis_check must be None, "warn" or "error", got '
                f"{analysis_check!r}"
            )
        # the build gate: statically analyze the whole program family
        # (paddle_tpu_torch.analysis, Engine.check_programs) before the
        # KV pool exists, and warn or raise on its blocking findings
        self.analysis_check = analysis_check
        # per-device memory budget gate (analysis level 3): when set,
        # the engine traces its whole program family over a fake pool
        # and compares each program's predicted peak against this byte
        # budget, refusing the config with an AnalysisError
        # (analysis_check="warn" degrades to a warning) BEFORE the KV
        # pool or any step buffer is allocated. None disables the gate.
        if device_memory_budget is not None:
            device_memory_budget = int(device_memory_budget)
            if device_memory_budget < 1:
                raise ValueError(
                    f"device_memory_budget must be >= 1 byte or None, "
                    f"got {device_memory_budget}"
                )
        self.device_memory_budget = device_memory_budget
        # persistent compile cache (paddle_tpu_torch.compilecache): a
        # directory path or a CompileCache. The programs' analysis
        # reports are stored there and read back by a later build (a warm
        # gated build traces nothing), and the whole program family is
        # captured at build, before the first request
        self.compile_cache = compile_cache


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
        self._chunking = cfg.prefill_chunk_tokens is not None
        # a continuation (prefill_ext) program can run: chunks, a prefix
        # hit's suffix, a partial spill restore's suffix
        self._use_ext = self._chunking or cfg.enable_prefix_cache
        # optional entry points are checked at build: one error naming
        # the missing method and the flags that need it
        if ((self._chunking or cfg.enable_prefix_cache)
                and not hasattr(self.adapter, "prefill_ext")):
            flags = [f for f, on in (
                ("enable_prefix_cache=True", cfg.enable_prefix_cache),
                (f"prefill_chunk_tokens={cfg.prefill_chunk_tokens}",
                 self._chunking)) if on]
            raise TypeError(
                f"{type(self.adapter).__name__} has no prefill_ext entry "
                f"point, but EngineConfig({', '.join(flags)}) needs an "
                "adapter that can continue a prefill at a nonzero cache "
                "length"
            )
        self._speculating = cfg.speculate_tokens is not None
        if self._speculating and not hasattr(self.adapter, "verify"):
            raise TypeError(
                f"{type(self.adapter).__name__} has no verify entry point, "
                f"but EngineConfig(speculate_tokens={cfg.speculate_tokens}) "
                "needs an adapter that can score a K+1-token draft window "
                "in one launch"
            )
        self.device = torch.device(self.adapter.device)
        self.engine_id = f"{next(_engine_counter):x}"
        # the metrics object doubles as a registry collector view
        # (paddle_tpu_serving_* series labeled engine=<id>)
        self.metrics = EngineMetrics(engine_id=self.engine_id)
        self.access_log = (resolve_access_log(cfg.access_log)
                           if cfg.access_log is not None else None)
        self.slo = SLOTracker(cfg.slo) if cfg.slo is not None else None
        self.metrics.slo = self.slo
        # the static analysis gates run first, over a fake pool and fake
        # step buffers (nothing is allocated, captured or launched): a
        # config the memory budget refuses, or a program with a blocking
        # finding, never allocates its pool
        self._program_analysis: dict = {}   # tag -> L3 summary
        self._trace_memo = None
        # the compile cache's stored reports stand in for the traces they
        # record (``_load_cached_analysis``)
        self._cc = self._manifest = None
        self._cached_reports: dict = {}     # tag -> stored reports
        self._fresh_l1: dict = {}           # tag -> L1 findings to store
        self._building = True
        if cfg.compile_cache is not None:
            from .. import compilecache

            self._cc = compilecache.resolve(cfg.compile_cache)
            self._load_cached_analysis()
        if (cfg.device_memory_budget is not None
                or cfg.analysis_check is not None):
            self._trace_memo = {}
            try:
                if cfg.device_memory_budget is not None:
                    self._enforce_memory_budget()
                if cfg.analysis_check is not None:
                    self.check_programs(
                        cfg.analysis_check,
                        compiled=cfg.device_memory_budget is not None)
            finally:
                self._trace_memo = None
        if self._cc is not None:
            self._store_analysis(self._program_tags())
        self._building = False
        # the device setup (pool, pinned staging buffers, generators,
        # graph pool, capture stream) takes the capture lock: a fleet
        # builds a restarted replica on another thread, and a cudaMalloc
        # or cudaHostAlloc there would invalidate a capture in progress
        with capture_lock:
            self._setup_device(cfg)
        if self._cc is not None:
            self._capture_family()
        if self.spill is not None:
            register_spill_view(self.spill, self.engine_id)
        # step observatory: per-program launch walls, goodput ledger,
        # bounded sample ring, live MFU, as its own weakref collector
        # view; a sampler crash (the obs.stepstats site) warns once and
        # disables it (_disable_stepstats)
        self.stepstats = None
        self._stepstats_warned = False
        if cfg.stepstats:
            self.stepstats = StepStats(adapter=self.adapter,
                                       ring=cfg.stepstats_ring)
            register_stepstats_view(self.stepstats, self.engine_id)
        # the journal replays before any traffic (the programs are
        # captured on first use, so before the first step): unfinished
        # journaled requests join the queue head
        self.journal = None
        self._journal_replaying = False
        if cfg.journal is not None:
            from .journal import resolve_journal

            self.journal = resolve_journal(cfg.journal, seed=cfg.seed)
            self._replay_journal()
        # /healthz aggregates this engine's health() through a weakref
        # (the provider never pins a dead engine's pool); finalize drops
        # it when the engine is collected
        probe_name = f"serving.engine.{self.engine_id}"

        def _probe(ref=weakref.ref(self)):
            eng = ref()
            return None if eng is None else eng.health()

        register_health_provider(probe_name, _probe)
        weakref.finalize(self, unregister_health_provider, probe_name)

    def _setup_device(self, cfg):
        """The KV pool, the spill tier, the scheduler's queues and slots,
        the generators and the programs' static buffers (``__init__``,
        under the capture lock). A pool that does not fit the card is
        refused as ``EngineOverloadedError`` (the pool released what it
        had allocated)."""
        dev = self.device
        try:
            self.pool = KVPool(
                self.adapter.num_layers, self.adapter.num_kv_heads,
                cfg.num_blocks, cfg.page_size, self.adapter.head_dim,
                self.adapter.dtype, dev, quant_dtype=cfg.kv_cache_dtype,
            )
        except RuntimeError as e:
            if isinstance(e, _DEVICE_FAULTS) or not is_resource_exhausted(e):
                raise
            # an admission-style refusal an operator (or a fleet
            # supervisor) can act on, instead of an opaque crash
            raise EngineOverloadedError(
                f"KV pool allocation exhausted device memory "
                f"({cfg.num_blocks} blocks x {cfg.page_size} tokens): "
                f"reduce num_blocks or quantize the cache "
                f"(kv_cache_dtype='int8') — {type(e).__name__}: {e}"
            ) from e
        self.block_manager = BlockManager(cfg.num_blocks, cfg.page_size)
        # host spill tier under the pool: its payload rows are one slab
        # allocated here (pinned on the card), sized to the byte budget
        # plus one max-length handle (a put lands before the LRU trims)
        self.spill = None
        self._spill_seq = 0
        self._spill_signature = None
        self._spill_warned = False
        if cfg.host_spill_bytes is not None:
            lay = self.pool.layout
            slab = PinnedSlab(
                lay.row_bytes,
                cfg.host_spill_bytes // lay.nbytes + cfg.pages_per_seq,
                pin=dev.type == "cuda")
            self.spill = HostSpillTier(
                cfg.host_spill_bytes, spill_dir=cfg.spill_dir,
                engine_id=self.engine_id, slab=slab)
            self._spill_signature = self.pool.block_signature()
        self.prefix_cache = (
            PrefixCache(self.block_manager, cfg.prefix_cache_blocks,
                        metrics=self.metrics, spill=self.spill,
                        pool=self.pool)
            if cfg.enable_prefix_cache else None)
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
        fields = self._buffer_fields()
        self._decode_buffers = StepBuffers(fields["decode"], dev)
        self._prefill_buffers = StepBuffers(fields["prefill"], dev)
        self._prefill_ext_buffers = StepBuffers(fields["prefill_ext"], dev)
        self._cow_buffers = StepBuffers(fields["cow"], dev)
        self._verify_buffers = (StepBuffers(fields["verify"], dev)
                                if self._speculating else None)
        self._decode_programs: dict = {}
        self._prefill_programs: dict = {}
        self._prefill_ext_programs: dict = {}
        self._cow_prog = self._verify_prog = None
        self._graph_pool = self._capture_stream = None
        if dev.type == "cuda":
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(dev)

    def _buffer_fields(self):
        """The programs' static inputs, by program: one buffer for both
        decode programs, one for every prefill bucket (a bucket's program
        reads the first ``bucket`` ids); ``StepBuffers`` fields."""
        cfg = self.config
        n, pps = cfg.max_batch_slots, cfg.pages_per_seq
        sampling = [("temperature", 1, "float32"), ("top_k", 1, "int32"),
                    ("top_p", 1, "float32"), ("do_sample", 1, "int32")]
        fields = {
            "decode": [("tokens", n, "int32"), ("positions", n, "int32"),
                       ("active", n, "int32"), ("tables", n * pps, "int32")]
            + [(name, n, t) for name, _, t in sampling],
            "prefill": [("ids", cfg.prefill_buckets[-1], "int32"),
                        ("length", 1, "int32"), ("table", pps, "int32")]
            + sampling,
            "prefill_ext": [("ids", cfg.prefill_buckets[-1], "int32"),
                            ("length", 1, "int32"),
                            ("cache_len", 1, "int32"),
                            ("table", pps, "int32")] + sampling,
            "cow": [("src", 1, "int32"), ("dst", 1, "int32")],
        }
        if self._speculating:
            fields["verify"] = [
                ("tokens", n * (cfg.speculate_tokens + 1), "int32"),
                ("positions", n, "int32"), ("draft_lens", n, "int32"),
                ("active", n, "int32"), ("tables", n * pps, "int32")]
        return fields

    # -- durable request journal (serving/journal.py) ------------------------
    def _replay_journal(self):
        """Crash recovery: fold the journal into unfinished requests and
        re-admit them at the HEAD of the queue, oldest first. Each
        carries its emitted tokens, so ``resume``'s re-prefill rebuilds
        its KV over ``prompt + output[:-1]`` and no journaled token is
        emitted again. Requests whose TTL lapsed while the process was
        down retire as ``"timeout"``. The re-admissions are journaled
        again (ADMIT with the cursor) so the dead incarnation's segments
        compact once the recovered work drains."""
        from .journal import restore_entries

        entries = self.journal.replay()
        if not entries:
            self.journal.flush()
            return
        live, expired = restore_entries(
            self.journal, entries,
            lambda e, params: Request(e.prompt, params, request_id=e.rid),
        )
        self.metrics.requests_timeout += expired
        self._journal_replaying = True
        try:
            for req in reversed(live):
                self.resume(req)
        finally:
            self._journal_replaying = False
        for req in live:   # re-ADMIT in admission order, cursor kept
            self.journal.admit(req)
        self.journal.flush()
        _flight.record(
            "serving", "journal-recovered", engine=self.engine_id,
            requests=len(live), expired=len(entries) - len(live),
        )

    # -- programs ------------------------------------------------------------
    def _program(self, fn, generator):
        return Program(fn, self.device, pool=self._graph_pool,
                       stream=self._capture_stream, generators=(generator,)
                       if generator is not None else ())

    def _capture(self, name, signature):
        """The compile log's watch around one program build: the engine
        id in the signature (a second engine building its own programs is
        a fresh capture, not a retrace)."""
        return jit_events.watch(f"serving.{name}", kind="serving",
                                signature=f"{self.engine_id}:{signature}")

    def _decode_program(self, any_sample):
        """The decode program over every slot; ``any_sample`` (a host
        bool) adds the sampling warp and the noise, as JAX's static
        flag: at most two programs exist."""
        prog = self._decode_programs.get(any_sample)
        if prog is not None:
            return prog
        gen = self._generator
        self._pin_adapter()
        # the build runs the function once eagerly: over zeroed inputs (no
        # active slot) it writes no page
        self._decode_buffers.device.zero_()
        with self._capture("decode", f"any_sample={any_sample}"):
            prog = self._program(
                self._decode_fn(self._decode_buffers.dev, self.pool,
                                any_sample, gen),
                gen if any_sample else None)
        self._decode_programs[any_sample] = prog
        self.metrics.decode_compiles += 1
        return prog

    def _decode_fn(self, f, pool, any_sample, gen):
        """The decode program's function over buffers ``f`` and ``pool``
        (the engine's own, or the analyzer's fake ones)."""
        adapter, cfg = self.adapter, self.config
        tables = f["tables"].view(cfg.max_batch_slots, cfg.pages_per_seq)

        def decode_fn():
            logits = adapter.decode(pool.k, pool.v, f["tokens"],
                                    f["positions"], tables, f["active"] != 0)
            u = (uniform_noise(logits.shape, gen, logits.device)
                 if any_sample else None)
            nxt = sample_tokens(logits, f["temperature"], f["top_k"],
                                f["top_p"], f["do_sample"], u)
            return nxt, logits

        return decode_fn

    def _prefill_program(self, bucket):
        """The prefill program of one length bucket: the prompt's logits
        at ``length - 1``, then its token (greedy or sampled, as the
        request's parameters say; the noise from the prefill
        generator)."""
        prog = self._prefill_programs.get(bucket)
        if prog is not None:
            return prog
        gen = self._prefill_generator
        self._pin_adapter()
        # the build runs the function once eagerly: over zeroed inputs (a
        # prompt of length 0) it writes no page
        self._prefill_buffers.device.zero_()
        with self._capture("prefill", f"bucket={bucket}"):
            prog = self._program(
                self._prefill_fn(self._prefill_buffers.dev, self.pool,
                                 bucket, gen), gen)
        self._prefill_programs[bucket] = prog
        self.metrics.prefill_compiles += 1
        return prog

    def _prefill_fn(self, f, pool, bucket, gen):
        """The prefill program's function of one bucket over buffers
        ``f`` and ``pool``."""
        adapter = self.adapter
        ids = f["ids"][:bucket]

        def prefill_fn():
            logits = adapter.prefill(pool.k, pool.v, ids, f["length"][0],
                                     f["table"])
            u = uniform_noise((1, logits.shape[-1]), gen, logits.device)
            tok = sample_tokens(logits[None], f["temperature"], f["top_k"],
                                f["top_p"], f["do_sample"], u)
            return tok, logits

        return prefill_fn

    def _prefill_ext_program(self, bucket):
        """The continuation program of one length bucket: the chunk's
        logits at ``length - 1`` after ``cache_len`` cached tokens, then
        its token (the host stages greedy parameters for a non-final
        chunk, whose token is discarded)."""
        prog = self._prefill_ext_programs.get(bucket)
        if prog is not None:
            return prog
        gen = self._prefill_generator
        self._pin_adapter()
        # the build runs the function once eagerly: over zeroed inputs (a
        # chunk of length 0) it writes no page
        self._prefill_ext_buffers.device.zero_()
        with self._capture("prefill_ext", f"bucket={bucket}"):
            prog = self._program(
                self._prefill_ext_fn(self._prefill_ext_buffers.dev,
                                     self.pool, bucket, gen), gen)
        self._prefill_ext_programs[bucket] = prog
        self.metrics.prefill_ext_compiles += 1
        return prog

    def _prefill_ext_fn(self, f, pool, bucket, gen):
        """The continuation program's function of one bucket over
        buffers ``f`` and ``pool``."""
        adapter = self.adapter
        ids = f["ids"][:bucket]

        def prefill_ext_fn():
            logits = adapter.prefill_ext(pool.k, pool.v, ids, f["length"][0],
                                         f["cache_len"][0], f["table"])
            u = uniform_noise((1, logits.shape[-1]), gen, logits.device)
            tok = sample_tokens(logits[None], f["temperature"], f["top_k"],
                                f["top_p"], f["do_sample"], u)
            return tok, logits

        return prefill_ext_fn

    def _cow_program(self):
        """The copy-on-write program: block ``src`` over block ``dst`` in
        every layer's pages (``KVPool.copy_block``)."""
        if self._cow_prog is not None:
            return self._cow_prog
        # the build runs the function once eagerly: the sink page over
        # itself
        self._cow_buffers.device.fill_(self.pool.sink_page)
        with self._capture("cow", "copy"):
            self._cow_prog = self._program(
                self._cow_fn(self._cow_buffers.dev, self.pool), None)
        self.metrics.cow_compiles += 1
        return self._cow_prog

    @staticmethod
    def _cow_fn(f, pool):
        """The copy-on-write program's function over buffers ``f`` and
        ``pool``."""

        def cow_fn():
            pool.copy_block(f["src"][0], f["dst"][0])

        return cow_fn

    def _verify_program(self):
        """The verify program: every slot's K+1-token window scored in one
        pass, returning ``(argmax targets int32 [slots, K+1], logits)``
        (JAX's ``verify_fn``). Greedy-only, so it takes no generator: one
        per engine."""
        if self._verify_prog is not None:
            return self._verify_prog
        self._pin_adapter()
        # the build runs the function once eagerly: over zeroed inputs (no
        # active slot) it writes no page and reads page 0 only
        self._verify_buffers.device.zero_()
        with self._capture("verify", f"k={self.config.speculate_tokens}"):
            self._verify_prog = self._program(
                self._verify_fn(self._verify_buffers.dev, self.pool), None)
        self.metrics.verify_compiles += 1
        return self._verify_prog

    def _verify_fn(self, f, pool):
        """The verify program's function over buffers ``f`` and
        ``pool``."""
        adapter, cfg = self.adapter, self.config
        n = cfg.max_batch_slots
        tokens = f["tokens"].view(n, cfg.speculate_tokens + 1)
        tables = f["tables"].view(n, cfg.pages_per_seq)

        def verify_fn():
            logits = adapter.verify(pool.k, pool.v, tokens, f["positions"],
                                    f["draft_lens"], tables,
                                    f["active"] != 0)
            return logits.argmax(-1).to(torch.int32), logits

        return verify_fn

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

    # -- persistent compile cache (paddle_tpu_torch.compilecache) -----------
    def _service_signature(self):
        """What every program of this engine depends on: the weights'
        shapes and dtypes, the pool, the config fields that shape a
        program, the adapter's code identity and the kernel libraries
        (JAX's service key, plus the libraries)."""
        from ..compilecache import abstractify, code_fingerprint, \
            signature_str
        from ..kernels._build import library_digests

        cfg, ad = self.config, self.adapter
        model = getattr(ad, "model", None)
        weights = (signature_str(abstractify(dict(model.state_dict())))
                   if model is not None else type(ad).__qualname__)
        code = "|".join(
            [type(ad).__qualname__]
            + [code_fingerprint(getattr(ad, name, None)) or "?"
               for name in ("prefill", "decode", "prefill_ext", "verify")])
        libs = ",".join(f"{k}={v}" for k, v in
                        sorted(library_digests().items()))
        return (
            f"{weights}|layers={ad.num_layers}|kvh={ad.num_kv_heads}"
            f"|d={ad.head_dim}|dtype={ad.dtype}|dev={self.device.type}"
            f"|slots={cfg.max_batch_slots}|mml={cfg.max_model_len}"
            f"|page={cfg.page_size}|blocks={cfg.num_blocks}"
            f"|buckets={cfg.prefill_buckets}"
            f"|chunk={cfg.prefill_chunk_tokens}"
            f"|pfx={int(cfg.enable_prefix_cache)}"
            f"|spec={cfg.speculate_tokens}"
            f"|dk={cfg.decode_kernel}|kvq={cfg.kv_cache_dtype}"
            f"|code={code}|kernels={libs}"
        )

    def _program_meta(self, tag):
        """``(name, signature, store key)`` of one program."""
        name = "serving." + self._program_label(*tag)
        sig = f"{name}|{self._service_sig}"
        return name, sig, self._cc.key(name, sig)

    def _load_cached_analysis(self):
        """Open this service's manifest and read every program's stored
        reports: each L3 summary fills ``_program_analysis`` and the L1
        reports stand in for the traces (``_check_family``), so the gates
        re-evaluate over them with no trace. Each program read is one
        ``aot-hit``; a missing or damaged artifact is a miss or a counted,
        warned fallback, and that program is traced as on a cold
        build."""
        import hashlib
        import json

        self._service_sig = self._service_signature()
        self._service_key = hashlib.sha256(
            self._service_sig.encode()).hexdigest()[:16]
        self._manifest = self._cc.manifest(self._service_key)
        self._manifest.load()
        m = self._cc.metrics
        before = (m.hits, m.misses, m.fallbacks)
        for tag in self._program_tags():
            name, sig, key = self._program_meta(tag)
            got = self._cc.load_artifact(
                key, name=name, signature=sig,
                finish=lambda meta, blobs: json.loads(blobs["analysis"]))
            if got is None:
                continue
            self._cached_reports[tag] = got
            if got.get("summary") is not None:
                self._record_summary(tag, got["summary"])
        _flight.record(
            "compilecache", "warm-start", engine=self.engine_id,
            hits=m.hits - before[0], misses=m.misses - before[1],
            fallbacks=m.fallbacks - before[2],
        )

    def _store_analysis(self, tags):
        """Store the reports of ``tags`` that this engine computed afresh
        and list every one in the manifest (one atomic rewrite)."""
        import json

        for tag in tags:
            cached = self._cached_reports.get(tag, {})
            report = {"summary": self._program_analysis.get(tag),
                      "l1": self._fresh_l1.pop(tag, cached.get("l1"))}
            name, sig, key = self._program_meta(tag)
            extra = {}
            if report["summary"] and report["summary"].get("memory"):
                extra["memory"] = int(report["summary"]["memory"]["peak"])
            if report != self._cached_reports.get(tag):
                data = json.dumps(report, sort_keys=True).encode()
                if self._cc.store_artifact(
                        key, {"analysis": data}, name=name, signature=sig,
                        extra_meta=extra):
                    self._cached_reports[tag] = json.loads(data)
            kind, bucket, any_sample = tag
            self._manifest.add(name, sig, key, kind=kind, bucket=bucket,
                               any_sample=any_sample, **extra)
        try:
            self._manifest.save()
        except OSError as e:
            warnings.warn(f"[compilecache] manifest save failed (a warm "
                          f"restart will miss these programs): {e}")

    def _capture_family(self):
        """Capture every program of the family (``_program_tags``: the
        manifest's program set) before the first request, each through
        its builder (``_capture``'s watch, the capture lock): a CUDA graph
        cannot be serialized, so a warm start still captures; what it
        skips is the analysis."""
        for kind, bucket, any_sample in self._program_tags():
            if kind == "decode":
                self._decode_program(any_sample)
            elif kind == "prefill":
                self._prefill_program(bucket)
            elif kind == "prefill_ext":
                self._prefill_ext_program(bucket)
            elif kind == "cow":
                self._cow_program()
            else:
                self._verify_program()

    # -- static analysis gates (paddle_tpu_torch.analysis L1 + L3) -----------
    def check_programs(self, mode="error", compiled=True):
        """THE analysis gate over this engine's whole program family.

        Level 1: the decode program (greedy and sampling variants), the
        prefill programs (one-shot, continuation and the COW copy, as
        enabled) and the speculative verify program (when enabled) are
        traced over fake tensors (never executed, never captured) and
        held to zero host-sync, capture-hazard (``retrace-hazard``) and
        ``dtype-drift`` findings: a CUDA graph replays whatever its
        capture froze, every step. Level 3 (``compiled=True``): every
        program in the family is summarized (collective census,
        predicted per-device peak) and run through the compiled-program
        rules against ``EngineConfig(device_memory_budget=)``; findings
        are enforced per ``mode`` via ``analysis.enforce``.

        ``EngineConfig(analysis_check=)`` runs this at build, before the
        KV pool is allocated (level 3 included when the memory gate is
        armed). Returns the merged analysis Report. Nothing is captured,
        launched or allocated on the device, and no capture counter or
        capture-log event moves.

        ``mode``: "error" raises ``analysis.AnalysisError`` on a
        blocking finding (and on an analyzer failure); "warn" degrades
        everything to warnings.
        """
        from .. import analysis

        if mode not in ("warn", "error"):
            raise ValueError(
                f'check_programs mode must be "warn" or "error", got '
                f"{mode!r}"
            )
        report = analysis.Report()
        report.extend(self._check_decode(mode).findings)
        report.extend(self._check_prefill(mode).findings)
        if self._speculating:
            report.extend(self._check_verify(mode).findings)
        if compiled:
            r3 = self.check_compiled_programs()
            analysis.enforce(
                r3, mode, what="serving compiled program family"
            )
            report.extend(r3.findings)
        return report

    def check_decode(self, mode="error"):
        """Thin delegate: the decode slice of :meth:`check_programs`
        (level 1 only), kept for callers that gate one program."""
        return self._check_decode(mode)

    def check_prefill(self, mode="error"):
        """Thin delegate: the prefill slice of :meth:`check_programs`
        (level 1 only)."""
        return self._check_prefill(mode)

    def check_verify(self, mode="error"):
        """Thin delegate: the speculative-verify slice of
        :meth:`check_programs` (level 1 only)."""
        return self._check_verify(mode)

    def _program_tags(self):
        """Every ``(kind, bucket, any_sample)`` in this engine's program
        family: the set the level-3 checks summarize."""
        cfg = self.config
        tags = [("decode", None, False), ("decode", None, True)]
        tags += [("prefill", b, False) for b in cfg.prefill_buckets]
        if self._use_ext:
            tags += [
                ("prefill_ext", b, False) for b in cfg.prefill_buckets
            ]
            if cfg.enable_prefix_cache:
                tags.append(("cow", None, False))
        if self._speculating:
            tags.append(("verify", None, False))
        return tags

    @staticmethod
    def _program_label(kind, bucket, any_sample):
        """``decode``, ``decode+sample``, ``prefill[16]``, ...: the
        ``metrics.program_bytes`` key (JAX's labels)."""
        label = kind if bucket is None else f"{kind}[{bucket}]"
        return label + "+sample" if any_sample else label

    def _analysis_env(self):
        """The analyzer's stand-ins for the device state, all fake
        tensors of one ``FakeTensorMode`` (no memory): the pool
        (``KVPool.abstract``, its ``__init__`` never runs), every
        program's step buffers, and a generator the fake draws do not
        advance. The model's weights enter as the programs reach them."""
        from types import SimpleNamespace

        from ..analysis.trace import fake_mode

        cfg, ad, dev = self.config, self.adapter, self.device
        mode = fake_mode()
        pool = KVPool.abstract(
            ad.num_layers, ad.num_kv_heads, cfg.num_blocks, cfg.page_size,
            ad.head_dim, ad.dtype, dev, cfg.kv_cache_dtype, mode)
        with mode:
            bufs = {name: StepBuffers.abstract(fields, dev)
                    for name, fields in self._buffer_fields().items()}
        return SimpleNamespace(mode=mode, pool=pool, bufs=bufs,
                               gen=torch.Generator(device=dev))

    def _trace_program(self, kind, bucket=None, any_sample=False,
                       mode="collect"):
        """``(TraceResult or None, Report)`` of one program's function
        over the analysis stand-ins (``analysis.api.traced``); within one
        gate run (``_trace_memo``) a program is traced once."""
        from ..analysis.api import traced

        tag = (kind, bucket, bool(any_sample))
        memo = self._trace_memo
        if memo is not None and tag in memo:
            return memo[tag]
        env = self._analysis_env()
        f = env.bufs[kind].dev
        if kind == "decode":
            fn = self._decode_fn(f, env.pool, any_sample, env.gen)
        elif kind == "prefill":
            fn = self._prefill_fn(f, env.pool, bucket, env.gen)
        elif kind == "prefill_ext":
            fn = self._prefill_ext_fn(f, env.pool, bucket, env.gen)
        elif kind == "cow":
            fn = self._cow_fn(f, env.pool)
        else:
            fn = self._verify_fn(f, env.pool)
        self._pin_adapter()
        root = "serving." + self._program_label(kind, bucket, False)
        got = traced(fn, mode=mode, root=root, fake=env.mode)
        if memo is not None:
            memo[tag] = got
        return got

    def _check_family(self, programs, mode, what):
        """Level 1 over ``programs`` (``(kind, bucket, any_sample)``):
        one report, findings shared by several programs kept once,
        blocking findings enforced per ``mode``."""
        from .. import analysis

        if mode not in ("warn", "error"):
            raise ValueError(
                f'{what} mode must be "warn" or "error", got {mode!r}'
            )
        report = analysis.Report()
        seen = set()
        fresh = []
        for kind, bucket, any_sample in programs:
            tag = (kind, bucket, bool(any_sample))
            stored = self._cached_reports.get(tag, {}).get("l1")
            if stored is not None:   # from the compile cache: no trace
                findings = [_finding(d) for d in stored]
            else:
                tr, crash = self._trace_program(kind, bucket, any_sample,
                                                mode)
                root = "serving." + self._program_label(kind, bucket, False)
                findings = (crash if tr is None else analysis.check_call(
                    None, mode=mode, root=root, trace_result=tr)).findings
                if self._cc is not None:
                    self._fresh_l1[tag] = [_finding_dict(f)
                                           for f in findings]
                    fresh.append(tag)
            for f in findings:
                key = (f.rule, f.file, f.line, f.message)
                if key not in seen:  # shared-path findings once
                    seen.add(key)
                    report.add(f)
        if self._cc is not None and fresh and not self._building:
            self._store_analysis(fresh)   # a gate run after the build
        blocking = [f for f in report.findings
                    if f.rule in _BLOCKING_RULES]
        if blocking:
            msg = (
                f"serving {_INVARIANTS[what]} failed static analysis:\n"
                + "\n".join(f.render() for f in blocking)
            )
            if mode == "error":
                raise analysis.AnalysisError(msg, report)
            warnings.warn(msg, stacklevel=3)
        return report

    def _check_decode(self, mode="error"):
        """The decode slice of :meth:`check_programs` (level 1): both
        programs (greedy, and with the sampling warp and its noise), so
        a hazard in the sampling path does not wait for the first
        sampled request."""
        return self._check_family(
            [("decode", None, False), ("decode", None, True)], mode,
            "check_decode")

    def _check_prefill(self, mode="error"):
        """The prefill slice of :meth:`check_programs` (level 1): the
        one-shot prefill, the continuation (chunked prefill, a prefix
        hit's suffix) and the copy-on-write copy, each as enabled, at the
        first bucket."""
        cfg = self.config
        bucket = cfg.prefill_buckets[0]
        programs = [("prefill", bucket, False)]
        if self._use_ext:
            programs.append(("prefill_ext", bucket, False))
            if cfg.enable_prefix_cache:
                programs.append(("cow", None, False))
        return self._check_family(programs, mode, "check_prefill")

    def _check_verify(self, mode="error"):
        """The speculative-verify slice of :meth:`check_programs` (level
        1): the draft-window scoring program."""
        if mode not in ("warn", "error"):
            raise ValueError(
                f'check_verify mode must be "warn" or "error", got '
                f"{mode!r}"
            )
        if self.config.speculate_tokens is None:
            raise RuntimeError(
                "check_verify needs EngineConfig(speculate_tokens=): "
                "this engine has speculation disabled"
            )
        return self._check_family([("verify", None, False)], mode,
                                  "check_verify")

    def _program_summary(self, kind, bucket=None, any_sample=False):
        """One program's L3 summary (collective census, predicted
        per-device memory), memoized; records its predicted peak in
        ``metrics.program_bytes``."""
        from ..analysis import AnalysisError
        from ..analysis.compiled import program_summary

        tag = (kind, bucket, bool(any_sample))
        s = self._program_analysis.get(tag)
        if s is not None:
            return s
        tr, _ = self._trace_program(kind, bucket, any_sample, mode="error")
        if tr is None:   # a crash raised under mode="error"
            raise AnalysisError(f"analysis trace of {kind} failed")
        s = program_summary(tr)
        self._record_summary(tag, s)
        return s

    def _record_summary(self, tag, summary):
        """Memoize one program's L3 summary and record its predicted peak
        in ``metrics.program_bytes``."""
        self._program_analysis[tag] = summary
        if summary.get("memory"):
            self.metrics.program_bytes[self._program_label(*tag)] = int(
                summary["memory"]["peak"])

    def check_compiled_programs(self, passes=None):
        """Level-3 analysis over the whole program family: run the
        compiled-program rule set (collective census, per-device memory
        budget: ``analysis.compiled.COMPILED_PASSES``) over every
        program's summary and return the collected Report. Pure
        collection: callers (:meth:`check_programs`, the build-time
        memory gate) enforce; a crashing pass or a program that cannot
        be summarized degrades to a ``pass-crash`` finding, never an
        exception (the ``analysis.compiled`` fault-site contract), but a
        device error re-raises."""
        from .. import analysis
        from ..analysis.compiled import summary_findings

        cfg = self.config
        report = analysis.Report()
        for kind, bucket, any_sample in self._program_tags():
            label = "serving." + self._program_label(kind, bucket,
                                                     any_sample)
            try:
                summary = self._program_summary(kind, bucket, any_sample)
            except _DEVICE_FAULTS:
                raise
            except Exception as e:
                # analysis: allow(broad-except) an analyzer failure
                # degrades like a crashing pass: L3 must never take down
                # an engine build
                report.add(analysis.Finding(
                    rule="pass-crash",
                    severity=analysis.Severity.WARNING,
                    message=(
                        f"compiled analysis of {label} crashed: {e!r}"
                    ),
                    root=label,
                ))
                continue
            report.extend(summary_findings(
                summary,
                program=label,
                tp_numerics=None,
                tp_degree=1,
                device_memory_budget=cfg.device_memory_budget,
                mode="collect",
                passes=passes,
            ))
        return report

    def _enforce_memory_budget(self):
        """The build-time memory gate: the family's predicted per-device
        peaks against ``EngineConfig(device_memory_budget=)``, refused
        (``analysis_check=None``/"error") or warned ("warn") BEFORE the
        KV pool exists: a config that would run out of device memory
        never allocates its pool."""
        from .. import analysis

        mode = self.config.analysis_check or "error"
        report = self.check_compiled_programs(passes=("memory-budget",))
        analysis.enforce(
            report, mode,
            what=(
                "serving program family under EngineConfig("
                f"device_memory_budget={self.config.device_memory_budget})"
            ),
        )
        return report

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
            # pressure is ACTIVE utilization: cached prefix blocks no
            # request holds are capacity the engine takes back at will
            bm = self.block_manager
            reclaimable, util = self._active_pressure()
            admissible_now = (
                not self.waiting and None in self.slots
                and bm.num_free + reclaimable >= bm.blocks_needed(
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
        if self.journal is not None and not self._journal_replaying:
            # WAL the admission (buffered urgent; the step's flush makes
            # it durable before any of its tokens can be)
            self.journal.admit(req)
        return req

    def _active_pressure(self):
        """``(reclaimable_blocks, active_utilization)``: the pressure
        split shedding and ``health()`` agree on. Cached prefix blocks
        no running request holds and idle speculative draft headroom are
        reclaimable capacity, not pressure, so a pool kept warm by the
        prefix cache (or padded by headroom) neither sheds admissions nor
        reads as overloaded."""
        bm = self.block_manager
        reclaimable = (self.prefix_cache.reclaimable_blocks()
                       if self.prefix_cache is not None else 0)
        if self._speculating:
            reclaimable += sum(self._spec_headroom(r) for r in self.slots)
        return reclaimable, (bm.num_used - reclaimable) / bm.num_blocks

    def _spec_headroom(self, req):
        """Idle draft-headroom blocks a greedy RUNNING slot holds beyond
        its required ``num_cached + 1`` coverage (0 for every other slot):
        the one definition behind pressure (``_active_pressure``) and
        reclaim (``_reclaim_spec_headroom``)."""
        if (req is None or req.state is not RequestState.RUNNING
                or req.sampling_params.do_sample):
            return 0
        return max(len(req.block_ids)
                   - self.block_manager.blocks_needed(req.num_cached + 1), 0)

    def resume(self, req):
        """Re-enqueue a request whose KV state was lost outside this
        engine (``release`` on another engine): scheduling state is
        reset, prompt and generated tokens kept, so the next prefill
        rebuilds the cache over ``prompt + output[:-1]`` and greedy
        continuation is byte-identical — or, when the request carries a
        spill handle a tier in this process (or the disk tier) still
        holds, its admission restores the blocks instead. Joins the head
        of the queue and bypasses ``max_waiting`` and shedding."""
        if req.state is RequestState.FINISHED:
            raise ValueError(
                f"cannot resume finished request {req.request_id!r}"
            )
        req.block_ids = []
        req.num_cached = 0
        req.slot = None
        req.state = RequestState.WAITING
        # goodput attribution: the re-prefill recomputes context built on
        # another engine — migration waste, not preemption (a spill
        # restore on admission makes it "restored")
        req.resume_cause = "migration"
        self.waiting.appendleft(req)
        self.metrics.requests_received += 1
        req.timeline.resumes += 1
        if self.journal is not None and not self._journal_replaying:
            # re-ADMIT with the emit cursor: replay must not count the
            # tokens this request already produced elsewhere again
            self.journal.admit(req)
        return req

    def release(self, request_id):
        """Detach an unfinished request WITHOUT finishing it: its KV
        blocks and slot are freed, its state resets to WAITING with
        ``num_cached=0``, and the Request (prompt, generated tokens,
        arrival and deadline) is returned for ``resume`` on another
        engine. No finish accounting and no RequestOutput. None when the
        id is not here. With the spill tier the cached blocks are parked
        first under a handle the request carries (and the journal's
        re-ADMIT records), so a ``resume`` in this process restores them
        from the peer tier instead of re-prefilling."""
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
        self._spill_request(req)
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
        poisoned or expired) or "overloaded" (admission queue full, or
        ACTIVE KV pressure at the shedding threshold; overloaded beats
        degraded);
        ``flags`` carries both signals. ``kv_utilization`` is the pool's
        raw use, ``kv_active_utilization`` leaves out the
        ``kv_reclaimable_blocks`` the prefix cache alone holds;
        ``prefix_cache_digests`` are the cached chain keys a router
        matches ``prompt_chain_digests`` against; ``spec_accept_rate`` is
        accepted over proposed draft tokens (None before any draft).
        Sustained SLO burn (``EngineConfig(slo=)``) is degraded too and
        adds the ``slo_burn`` flag; ``slo_burn_rates`` is the windowed
        burn per signal (None without an SLO). ``requests_errored`` and
        ``last_error`` report poison isolation; ``watchdog`` is JAX's
        value without a comm watchdog (the port has none). ``stepstats``
        is the observatory's summary and ``spill`` the tier's stats (None
        when off); ``kv_headroom_bytes_per_chip`` scales the headroom
        blocks by a block's bytes. The tensor-parallel fields report one
        card (``tp_degree`` 1). ``device_memory_budget`` is the config's
        and ``predicted_peak_bytes_per_chip`` the largest predicted peak
        of the programs the analyzer summarized (None before any)."""
        m, bm, cfg = self.metrics, self.block_manager, self.config
        util = bm.utilization()
        reclaimable, util_active = self._active_pressure()
        queue_full = (cfg.max_waiting is not None
                      and len(self.waiting) >= cfg.max_waiting)
        shedding = (cfg.kv_shed_threshold is not None
                    and util_active >= cfg.kv_shed_threshold)
        slo_burning = self.slo is not None and self.slo.burning()
        degraded = bool(m.requests_errored or m.requests_timeout
                        or slo_burning)
        overloaded = queue_full or shedding
        status = "ok"
        if degraded:
            status = "degraded"
        if overloaded:
            status = "overloaded"
        return {
            "status": status,
            "flags": [f for f, on in (("degraded", degraded),
                                      ("overloaded", overloaded),
                                      ("slo_burn", slo_burning)) if on],
            "slo_burn_rates": (self.slo.burn_rates()
                               if self.slo is not None else None),
            "queue_depth": len(self.waiting),
            "num_running": sum(r is not None for r in self.slots),
            "decode_kernel": cfg.decode_kernel,
            # the path the programs were built with: the configured one
            # on one card (JAX resolves a sharded engine's to "xla")
            "decode_kernel_effective": cfg.decode_kernel,
            "tp_degree": 1,
            "tp_numerics": None,
            "tp_devices": [],
            "kv_cache_dtype": cfg.kv_cache_dtype or str(
                self.pool.dtype).replace("torch.", ""),
            "kv_bytes_per_token": self.pool.bytes_per_token(),
            "kv_bytes_per_token_per_chip":
                self.pool.bytes_per_token_per_chip(),
            "device_memory_budget": cfg.device_memory_budget,
            "predicted_peak_bytes_per_chip": (
                max(m.program_bytes.values()) if m.program_bytes
                else None),
            "kv_utilization": util,
            "kv_active_utilization": util_active,
            "kv_reclaimable_blocks": reclaimable,
            "kv_headroom_blocks": bm.num_free + reclaimable,
            "kv_headroom_bytes_per_chip": int(
                (bm.num_free + reclaimable)
                * self.pool.block_bytes_per_chip()),
            "stepstats": (self.stepstats.summary()
                          if self.stepstats is not None else None),
            "prefix_cache_blocks": (len(self.prefix_cache)
                                    if self.prefix_cache is not None else 0),
            "prefix_cache_digests": (
                list(self.prefix_cache.chain_digests())
                if self.prefix_cache is not None else []),
            "spill": self.spill.stats() if self.spill is not None else None,
            "spec_accept_rate": m.spec_accept_rate,
            "requests_errored": m.requests_errored,
            "requests_timeout": m.requests_timeout,
            "requests_shed": m.requests_shed,
            "preemptions": m.preemptions,
            "last_error": m.last_error,
            "watchdog": {"enabled": False, "fired": None},
        }

    # -- scheduler -----------------------------------------------------------
    def step(self):
        """One scheduler iteration: expire TTLs, admit and prefill
        joiners, then one decode step over the running slots. Returns
        RequestOutputs of the requests that finished in this step."""
        finished = list(self._aborted)
        self._aborted.clear()
        if self.stepstats is not None:
            self.stepstats.begin_step()
        try:
            self._expire(finished)
            self._admit(finished)
            self._prefill_chunks(finished)
            if self._running():
                self._ensure_capacity()
                idxs = self._running()
                if idxs:
                    self._decode(idxs, finished)
        except Exception as e:
            _flight.record("serving", "engine-error", engine=self.engine_id,
                           error=f"{type(e).__name__}: {e}")
            # the engine is broken here: health() may raise over torn
            # state, and nothing on the postmortem path may displace the
            # exception being re-raised
            try:
                probe = self.health()
            except Exception as he:
                probe = {"error": f"health() failed: {he!r}"}
            _flight.dump("engine-error",
                         probes={f"serving.engine.{self.engine_id}": probe})
            raise
        if self.journal is not None:
            # batched EMIT + group write (finished requests buffered
            # theirs in _finish); a steady-state step is a near no-op
            # until the write interval elapses or a completion makes the
            # buffer urgent
            self.journal.step_flush(self.slots)
        m, bm = self.metrics, self.block_manager
        m.queue_depth = len(self.waiting)
        m.num_running = sum(r is not None for r in self.slots)
        m.cache_utilization = bm.utilization()
        m.kv_reclaimable_blocks, m.kv_active_utilization = (
            self._active_pressure())
        m.kv_headroom_blocks = bm.num_free + m.kv_reclaimable_blocks
        m.pool_high_water = bm.high_water
        if self.prefix_cache is not None:
            m.prefix_cache_blocks = len(self.prefix_cache)
        st = self.stepstats
        if st is not None:
            try:
                faults.fire("obs.stepstats", engine=self.engine_id)
                sample = st.end_step(
                    occupancy=m.num_running / self.config.max_batch_slots,
                    queue_depth=m.queue_depth,
                    kv_free_blocks=bm.num_free,
                    kv_reclaimable_blocks=m.kv_reclaimable_blocks,
                )
                if sample is not None:
                    # the flight recorder's step ring: a postmortem shows
                    # the last steps' attribution
                    _flight.record_step_sample(
                        dict(sample, engine=self.engine_id))
            except _DEVICE_FAULTS:
                raise
            except Exception as e:
                # degradable by contract: the observatory never takes the
                # step down with it
                self._disable_stepstats(e)
        return finished

    def _disable_stepstats(self, exc):
        """``obs.stepstats`` degradation: a crashing sampler is warned
        ONCE and dropped (its collector view unregisters through the
        weakref at the next scrape); serving goes on without it."""
        if not self._stepstats_warned:
            self._stepstats_warned = True
            warnings.warn(
                f"step observatory disabled for engine {self.engine_id} "
                f"after sampler failure: {type(exc).__name__}: {exc}",
                RuntimeWarning, stacklevel=2,
            )
        self.stepstats = None

    def _stepstats_launch(self, program, t0):
        """Record one launch's host wall since ``t0`` (taken before the
        launch's staging; a launch that reads back ends with that sync,
        so its wall is device-inclusive)."""
        st = self.stepstats
        if st is None:
            return
        try:
            st.record_launch(program, time.perf_counter() - t0)
        except Exception as e:
            self._disable_stepstats(e)

    def _note_prefill(self, req, n):
        """Goodput: a re-prefill over already-produced context (output
        tokens exist) recomputes, attributed to what forced it
        (``req.resume_cause``); a restore's residual prefill is useful."""
        if self.stepstats is not None:
            self.stepstats.note_prefill(
                n, cause=(req.resume_cause or "preempt")
                if req.output_token_ids else None)

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

    def _poison(self, req, exc, finished):
        """Contain a per-request failure: record it, finish the request
        with ``"error"``, keep the engine stepping."""
        req.error = f"{type(exc).__name__}: {exc}"
        m = self.metrics
        m.requests_errored += 1
        m.last_error = f"request {req.request_id}: {req.error}"
        self._finish(req, "error", finished)

    def _running(self):
        return [
            i for i, r in enumerate(self.slots)
            if r is not None and r.state is RequestState.RUNNING
        ]

    def _admit(self, finished):
        """FCFS admission into free slots. A request is admitted with its
        full block budget (whole prompt plus one decode write) but no
        compute: the prefix cache may cover a prefix through ``fork()``
        (copy-on-write when the one-token cap cuts into the last shared
        block), and the prefill itself runs in ``_prefill_chunks``. A
        request carrying a live spill handle skips the lookup: its own
        blocks come back from the host tier into its fresh allocation,
        and a handle covering every token to prefill makes it RUNNING
        with no prefill launch."""
        bm, pc = self.block_manager, self.prefix_cache
        while self.waiting and None in self.slots:
            req = self.waiting[0]
            tokens = req.tokens_to_prefill()
            restore_tokens = self._spill_restorable(req, tokens)
            # at least one token must remain to prefill: its logits seed
            # the first sampled token
            match = (pc.lookup(tokens, limit=len(tokens) - 1)
                     if pc is not None and restore_tokens is None
                     else None)
            n_fork = match.num_shared if match is not None else 0
            n_alloc = bm.blocks_needed(len(tokens) + 1) - n_fork
            if not bm.can_allocate(n_alloc):
                if pc is not None:
                    # retained cache blocks are reclaimable capacity, but
                    # never the ones this match is about to fork or copy
                    protect = set(match.shared_blocks if match else ())
                    if match is not None and match.cow_src is not None:
                        protect.add(match.cow_src)
                    pc.reclaim(n_alloc - bm.num_free, protect=protect)
                if not bm.can_allocate(n_alloc):
                    # idle draft headroom is reclaimable too: an admission
                    # never waits while speculation holds unused blocks
                    self._reclaim_spec_headroom(n_alloc - bm.num_free)
                if not bm.can_allocate(n_alloc):
                    break
            self.waiting.popleft()
            if pc is not None and restore_tokens is None:
                # one lookup per admission (blocked retries don't count)
                self.metrics.prefix_lookups += 1
            if restore_tokens is not None:
                req.block_ids = bm.allocate(n_alloc)
                # a failed restore keeps the blocks and recomputes:
                # num_cached=0 sends the whole prompt back through prefill
                req.num_cached = (restore_tokens
                                  if self._spill_restore(req, restore_tokens)
                                  else 0)
            elif match is not None:
                bm.fork(match.shared_blocks)
                req.block_ids = (list(match.shared_blocks)
                                 + bm.allocate(n_alloc))
                req.num_cached = match.cache_len
                pc.commit(match)
            else:
                req.block_ids = bm.allocate(n_alloc)
                req.num_cached = 0
            req.slot = self.slots.index(None)
            self.slots[req.slot] = req
            req.state = RequestState.PREFILLING
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            # queue wait ends at the FIRST slot assignment (re-admissions
            # after preemption keep the original stamp)
            tl = req.timeline
            first_admission = tl.admitted is None
            tl.mark_admitted(self.engine_id)
            if first_admission:
                self.metrics.latency["queue"].record(tl.queue_wait_s)
            if match is not None:
                tl.prefix_hit_tokens += match.cache_len
            if match is not None and match.cow_src is not None:
                # the cap cut into the last shared block: this request
                # WRITES its final prefill token there, so it gets a
                # private copy (block n_fork, freshly allocated)
                try:
                    self._cow(match.cow_src, req.block_ids[n_fork])
                except _DEVICE_FAULTS:
                    raise
                except Exception as e:
                    self._poison(req, e, finished)
                    continue
            if (restore_tokens is not None
                    and req.num_cached >= len(tokens)):
                # fully covered restore: the cache holds prompt +
                # output[:-1], the pre-preemption decode state — no
                # prefill launch; RUNNING with the last token re-armed
                req.state = RequestState.RUNNING
                req.last_token = req.output_token_ids[-1]
                if pc is not None:
                    # publish the restored PROMPT blocks for reuse, as
                    # the post-prefill register does
                    pc.register(req.prompt_token_ids, req.block_ids,
                                req.num_cached)
                reason = req.check_stop(self.config.max_model_len)
                if reason:
                    self._finish(req, reason, finished)

    def _prefill_chunks(self, finished):
        """Prefill launches for the PREFILLING slots, oldest first.
        Without chunking every pending prefill completes this step (one
        launch each); with it at most ``max_prefill_chunks_per_step``
        chunk launches run, then the decode batch gets the step. Nothing
        cached and everything in one chunk runs the one-shot prefill
        program; every other case is a continuation launch."""
        cfg = self.config
        budget = cfg.max_prefill_chunks_per_step if self._chunking else None
        used = 0
        for req in sorted(
            (r for r in self.slots
             if r is not None and r.state is RequestState.PREFILLING),
            key=lambda r: r.admit_seq,
        ):
            while req.state is RequestState.PREFILLING:
                if budget is not None and used >= budget:
                    return
                used += 1
                tokens = req.tokens_to_prefill()
                remaining = tokens[req.num_cached:]
                chunk = (remaining[:cfg.prefill_chunk_tokens]
                         if self._chunking else remaining)
                final = req.num_cached + len(chunk) >= len(tokens)
                try:
                    if req.num_cached == 0 and final:
                        self._prefill(req, tokens)
                    else:
                        self._prefill_chunk(req, chunk, final)
                except _DEVICE_FAULTS:
                    raise
                except Exception as e:
                    self._poison(req, e, finished)
                    break
                if final:
                    req.state = RequestState.RUNNING
                    if self.prefix_cache is not None:
                        # publish the full PROMPT blocks (decode writes
                        # only at positions >= the prompt's length)
                        self.prefix_cache.register(
                            req.prompt_token_ids, req.block_ids,
                            req.num_cached)
                    reason = req.check_stop(cfg.max_model_len)
                    if reason:
                        self._finish(req, reason, finished)

    def _prefill(self, req, tokens):
        """Stage the prompt into the prefill buffer, run its bucket's
        program, read its token back."""
        faults.fire("serving.step", phase="prefill",
                    request_id=req.request_id)
        t0 = time.perf_counter()
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
        self._stepstats_launch("prefill", t0)
        req.num_cached = len(tokens)
        self.metrics.prefill_tokens += len(tokens)
        self.metrics.prefill_steps += 1
        req.timeline.prefill_chunks += 1
        req.timeline.prefill_tokens += len(tokens)
        self._note_prefill(req, len(tokens))
        self._finish_prefill(req, tok)

    def _prefill_chunk(self, req, chunk, final):
        """One continuation launch: ``chunk`` appended at cache position
        ``req.num_cached`` through its bucket's ``prefill_ext`` program.
        A non-final chunk is staged greedy (its token is discarded) and
        its token is not read back (its observatory wall is the host's
        enqueue time)."""
        faults.fire("serving.step", phase="prefill",
                    request_id=req.request_id)
        t0 = time.perf_counter()
        cfg = self.config
        bucket = next_bucket(len(chunk), cfg.prefill_buckets)
        bufs = self._prefill_ext_buffers
        h = bufs.np
        bufs.clear()
        h["ids"][: len(chunk)] = chunk
        h["length"][0] = len(chunk)
        h["cache_len"][0] = req.num_cached
        h["table"][: len(req.block_ids)] = req.block_ids
        self._stage_sampling(h, [req], slice(0, 1))
        if not final:
            h["do_sample"][0] = 0
        prog = self._prefill_ext_program(bucket)
        # after the build: its warm-up draws from the generator too; every
        # chunk keys the generator as JAX's _request_key keys a launch
        self._prefill_generator.manual_seed(self._request_seed(req))
        self._pin_adapter()
        bufs.stage()
        out = prog()
        tok = int(out[0].cpu()[0]) if final else None
        self._stepstats_launch("prefill_ext", t0)
        req.num_cached += len(chunk)
        self.metrics.prefill_tokens += len(chunk)
        self.metrics.prefill_steps += 1
        self.metrics.prefill_chunks += 1
        req.timeline.prefill_chunks += 1
        req.timeline.prefill_tokens += len(chunk)
        self._note_prefill(req, len(chunk))
        if final:
            self._finish_prefill(req, tok)

    def _finish_prefill(self, req, tok):
        """Book the first token once a request's whole prefill has landed
        (one-shot or final chunk)."""
        if req.output_token_ids:
            # re-prefill after preemption: the sampled token re-derives
            # output[-1]; keep the one already emitted
            req.last_token = req.output_token_ids[-1]
        else:
            req.first_token_time = time.perf_counter()
            req.timeline.first_token = req.first_token_time
            self.metrics.record_ttft(req.first_token_time - req.arrival_time)
            req.output_token_ids.append(tok)
            req.last_token = tok

    def _cow(self, src, dst):
        """Copy-on-write one physical block (every layer's pages) so a
        prefill can diverge from a shared partial block without touching
        the original: one replay of the copy program (nothing read back:
        its observatory wall is the host's enqueue time)."""
        t0 = time.perf_counter()
        bufs = self._cow_buffers
        bufs.clear()
        bufs.np["src"][0] = src
        bufs.np["dst"][0] = dst
        prog = self._cow_program()
        bufs.stage()
        prog()
        self._stepstats_launch("cow", t0)
        self.metrics.cow_copies += 1

    def _ensure_capacity(self):
        """Every running request needs a block for the KV slot its next
        decode step writes; preempt the youngest on exhaustion (after
        reclaiming cached blocks and draft headroom). With speculation,
        then grab draft headroom where the pool has free blocks."""
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
                if (self.prefix_cache is not None
                        and self.prefix_cache.reclaim(1)):
                    continue  # a cached block freed: retry the allocate
                if self._reclaim_spec_headroom(1):
                    continue  # idle draft headroom freed: retry
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
        if self._speculating:
            self._grab_spec_headroom()

    def _grab_spec_headroom(self):
        """Opportunistic draft headroom: a greedy slot's verify window
        writes up to K positions past the required one, so it takes free
        blocks for them, but never preempts or reclaims for them (the
        draft budget clamps each window to the blocks the slot owns, so
        speculation gives way to plain decode under pressure)."""
        cfg, bm = self.config, self.block_manager
        for req in self.slots:
            if (req is None or req.state is not RequestState.RUNNING
                    or req.sampling_params.do_sample):
                continue
            # no headroom beyond the drafts the request can still use
            # before its length cap, nor beyond the block table
            want = min(cfg.speculate_tokens,
                       req.sampling_params.max_new_tokens
                       - len(req.output_token_ids) - 1)
            if want <= 0:
                continue
            need = min(bm.blocks_needed(req.num_cached + 1 + want),
                       cfg.pages_per_seq)
            while len(req.block_ids) < need and bm.can_allocate(1):
                req.block_ids += bm.allocate(1)

    def _reclaim_spec_headroom(self, need):
        """Free up to ``need`` draft-headroom blocks (the tail blocks past
        a greedy running slot's required coverage; they hold at most dead
        draft writes, never shared). Returns the number freed."""
        if not self._speculating:
            return 0
        freed = 0
        for req in self.slots:
            extra = self._spec_headroom(req)
            while extra > 0 and freed < need:
                self.block_manager.free([req.block_ids.pop()])
                extra -= 1
                freed += 1
            if freed >= need:
                break
        return freed

    def _preempt(self, req):
        """Preemption: free the blocks, keep the tokens, requeue at the
        head. With the spill tier the cached blocks are parked in host
        memory first, so the re-admission restores them (no re-prefill);
        without it, or when the spill fails, the re-prefill recomputes
        them."""
        spilled = self._spill_request(req)
        self._release(req)
        req.state = RequestState.WAITING
        req.num_cached = 0
        # the re-prefill this forces recomputes tokens the ledger already
        # counted: preemption waste (a restore makes it "restored")
        req.resume_cause = "preempt"
        self.waiting.appendleft(req)
        self.metrics.preemptions += 1
        req.timeline.preemptions += 1
        _flight.record("serving", "preemption", engine=self.engine_id,
                       request_id=req.request_id, spilled=spilled)

    # -- host spill tier (serving/spill.py) ----------------------------------
    def _spill_request(self, req):
        """Park ``req``'s cached KV blocks in the host tier as ONE handle
        (all or nothing), keyed on the Request so its re-admission — here,
        or on a same-process survivor after ``release`` — can restore
        them. Best effort: the tier off, nothing cached, an injected
        ``kv.spill`` fault or the host budget return False and the
        free-and-recompute path applies unchanged; a
        ``torch.AcceleratorError`` re-raises. A successful spill is
        re-ADMITted to the journal, the handle beside the emit cursor."""
        if self.spill is None or req.num_cached < 1:
            return False
        need = self.block_manager.blocks_needed(req.num_cached)
        if need > len(req.block_ids):
            return False
        try:
            payload = self.pool.read_blocks(req.block_ids[:need],
                                            self.spill.slab)
        except _DEVICE_FAULTS:
            raise
        except (RuntimeError, ValueError) as e:
            # spill is an optimization: an unreadable pool (out of
            # memory for the staging buffer) degrades to recompute
            self.spill.note_spill_failure("request")
            self._warn_spill(f"KV spill read failed ({type(e).__name__}: "
                             f"{e}); preemption degrades to recompute")
            return False
        key = f"req:{req.request_id}:{self._spill_seq}"
        self._spill_seq += 1
        if not self.spill.put(key, payload, self._spill_signature,
                              num_tokens=req.num_cached, cls="request"):
            return False
        req.spill_key = key
        req.spill_tokens = req.num_cached
        req.spill_tier = self.spill
        if self.journal is not None and not self._journal_replaying:
            # latest ADMIT wins: this one carries the emit cursor and the
            # spill handle (the journal's "kv" field)
            self.journal.admit(req)
        return True

    def _warn_spill(self, text):
        if not self._spill_warned:
            self._spill_warned = True
            warnings.warn(f"[serving] {text} (warned once, counted)",
                          stacklevel=3)

    def _spill_restorable(self, req, tokens):
        """Admission peek: the token count a spilled handle would restore
        for ``req``, or None for the allocate-and-prefill path. The handle
        must be live in a tier (host, disk, a same-process peer) under
        this pool's signature; a PARTIAL restore leaves a suffix to
        prefill, which needs the ``prefill_ext`` program."""
        if req.spill_key is None:
            return None
        if self.spill is None:
            # a handle from a peer's tier that this engine cannot restore
            drop_handle(req)
            return None
        n = int(req.spill_tokens or 0)
        if (n < 1 or n > len(tokens)
                or (n < len(tokens) and not self._use_ext)
                or (n >= len(tokens) and not req.output_token_ids)
                or not self.spill.has(req.spill_key,
                                      self._spill_signature)):
            # unusable here, or the tier dropped it (or it lives in
            # another process): recompute, free it wherever it is still
            # held, and stop peeking every step
            drop_handle(req, self.spill)
            return None
        return n

    def _spill_restore(self, req, n_tokens):
        """Write ``req``'s spilled handle back into its freshly allocated
        blocks. True = restored (``num_cached`` may be set to
        ``n_tokens``); False degrades to recompute — the blocks stay
        allocated and the prefill rebuilds them. An out-of-memory write
        reclaims cold prefix blocks and retries once before degrading; a
        ``torch.AcceleratorError`` re-raises."""
        t0 = time.perf_counter()
        # req.spill_tier keeps the holding tier alive through the get
        payload = self.spill.get(req.spill_key, self._spill_signature,
                                 pop=True)
        # popped, or (an injected kv.restore fault) given up: either way
        # the handle is spent, and nothing of it stays in any tier
        drop_handle(req, self.spill)
        if payload is None:
            return False
        need = self.block_manager.blocks_needed(n_tokens)
        try:
            if len(payload) < need:
                return False
            try:
                self.pool.write_blocks(req.block_ids[:need], payload)
            except _DEVICE_FAULTS:
                raise
            except RuntimeError as e:
                if not (is_resource_exhausted(e)
                        and self.prefix_cache is not None):
                    raise
                # the memory-pressure ladder: reclaim, then retry once
                self.prefix_cache.reclaim(need, protect=req.block_ids)
                self.pool.write_blocks(req.block_ids[:need], payload)
        except _DEVICE_FAULTS:
            raise
        except (RuntimeError, ValueError) as e:
            # a failed device write, or a disk payload whose leaves do
            # not fit the pool: recompute
            self.spill.note_restore_failure("request")
            self._warn_spill(f"KV restore failed ({type(e).__name__}: "
                             f"{e}); degrading to recompute")
            return False
        finally:
            release = getattr(payload, "release", None)
            if release is not None:
                release()
        # goodput: any residual prefill (partial handle) is real forward
        # progress, not preemption waste
        req.resume_cause = "restored"
        self.spill.note_restored("request", payload,
                                 time.perf_counter() - t0)
        return True

    def _launch_decode(self, idxs):
        """Run the decode program with only ``idxs`` active: stage every
        slot's token, position, block table and sampling parameters into
        the host buffer, one copy to the device, one replay, one read-back
        of the [slots] next tokens. Slots are independent (each attends to
        its own pages), so any subset of the active mask gives its members
        the tokens the full batch would: the property poison isolation's
        bisection relies on."""
        faults.fire("serving.step", phase="decode",
                    request_ids=tuple(self.slots[i].request_id
                                      for i in idxs))
        t0 = time.perf_counter()
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
        self._stepstats_launch("decode", t0)
        self.metrics.decode_steps += 1
        return nxt

    def _decode(self, idxs, finished):
        """The step's decode over the running slots ``idxs``. With
        speculation, greedy slots draft first (``speculation.propose``,
        called through the module so it can be replaced); if any drafted,
        the greedy slots take one verify launch and the sampled ones the
        decode program, else every slot takes the decode program (it is
        cheaper than a draft-less window)."""
        if not self._speculating:
            self._decode_subset(idxs, finished)
            return
        greedy = [i for i in idxs
                  if not self.slots[i].sampling_params.do_sample]
        sampled = [i for i in idxs if self.slots[i].sampling_params.do_sample]
        drafts = {
            i: speculation.propose(
                self._draft_history(self.slots[i]),
                self._draft_budget(self.slots[i]),
                max_ngram=self.config.speculate_ngram,
            )
            for i in greedy
        }
        if not any(drafts.values()):
            self._decode_subset(idxs, finished)
            return
        self._verify_subset(greedy, finished, drafts)
        self._decode_subset(sampled, finished)

    def _draft_history(self, req):
        """The drafter's window: the last ``DEFAULT_LOOKBACK`` tokens of
        prompt + output, without copying the whole history each step."""
        lb = speculation.DEFAULT_LOOKBACK
        out = req.output_token_ids
        if len(out) >= lb:
            return out[-lb:]
        return req.prompt_token_ids[-(lb - len(out)):] + out

    def _draft_budget(self, req):
        """Draft tokens the slot may take this step: its window's writes
        stay inside the blocks it owns and inside ``max_model_len``, and
        it can use at most ``remaining - 1`` drafts before its length cap.
        0 makes the slot a plain decode row of the verify launch."""
        cfg = self.config
        ceiling = min(len(req.block_ids) * cfg.page_size, cfg.max_model_len)
        remaining = (req.sampling_params.max_new_tokens
                     - len(req.output_token_ids))
        return max(min(cfg.speculate_tokens, ceiling - (req.num_cached + 1),
                       remaining - 1), 0)

    def _launch_verify(self, idxs, drafts):
        """Run the verify program with only ``idxs`` active: stage each
        slot's window (pending token, then its draft), position, draft
        length and block table, one copy to the device, one replay, one
        read-back of the [slots, K+1] argmax targets (slots independent,
        as in ``_launch_decode``)."""
        faults.fire("serving.step", phase="verify",
                    request_ids=tuple(self.slots[i].request_id
                                      for i in idxs))
        t0 = time.perf_counter()
        cfg = self.config
        bufs = self._verify_buffers
        h = bufs.np
        bufs.clear()
        n = cfg.max_batch_slots
        tokens = h["tokens"].reshape(n, cfg.speculate_tokens + 1)
        tables = h["tables"].reshape(n, -1)
        for i in idxs:
            req, draft = self.slots[i], drafts.get(i, [])
            tokens[i, 0] = req.last_token
            tokens[i, 1:1 + len(draft)] = draft
            h["positions"][i] = req.num_cached
            h["draft_lens"][i] = len(draft)
            h["active"][i] = 1
            tables[i, : len(req.block_ids)] = req.block_ids
        prog = self._verify_program()
        self._pin_adapter()
        bufs.stage()
        tgt = prog()[0].cpu().numpy()
        self._stepstats_launch("verify", t0)
        self.metrics.verify_steps += 1
        return tgt

    def _verify_subset(self, idxs, finished, drafts):
        """Speculative decode of the greedy slots ``idxs``: each accepts
        the longest draft prefix equal to the targets and emits targets
        0..accepted (the accepted drafts' successors and the token after
        them), each through the per-token stop check, so an EOS inside an
        accepted draft stops exactly where plain decode would. Their K/V
        is in the pages already; a rejected position's write is dead
        (``num_cached`` stops short of it). Poison isolation as
        ``_decode_subset``'s."""
        if not idxs:
            return
        tgt = self._isolate(
            idxs, finished, lambda s: self._launch_verify(s, drafts),
            lambda s: self._verify_subset(s, finished, drafts))
        if tgt is None:
            return
        cfg, m, st = self.config, self.metrics, self.stepstats
        for i in idxs:
            req, draft = self.slots[i], drafts.get(i, [])
            a = speculation.accept_length(draft, tgt[i, :len(draft)])
            req.timeline.verify_steps += 1
            if draft:
                # draft-less slots are plain decodes, not samples
                m.spec_proposed += len(draft)
                m.spec_accepted += a
                m.record_spec_accept(a)
                req.timeline.spec_accepted += a
                if st is not None and len(draft) > a:
                    # rejected drafts took verify compute for tokens
                    # nobody keeps: the ledger's spec_reject class
                    st.note_spec_reject(len(draft) - a)
            for j in range(a + 1):
                tok = int(tgt[i, j])
                req.num_cached += 1
                req.output_token_ids.append(tok)
                req.last_token = tok
                m.decode_tokens += 1
                req.timeline.decode_tokens += 1
                if st is not None:
                    st.note_decode(1)
                reason = req.check_stop(cfg.max_model_len)
                if reason:
                    self._finish(req, reason, finished)
                    break

    def _isolate(self, idxs, finished, launch, recurse):
        """Poison isolation for a batched launch (decode or verify): run
        ``launch(idxs)``; on failure carve the poison request out, by the
        exception's ``request_id`` or by bisecting the active mask through
        ``recurse(subset)``, and finish it with an error while the rest
        still run this step. Returns the launch's result, or None when
        the failure was contained (the subsets booked their own tokens).
        A device fault re-raises at once."""
        try:
            return launch(idxs)
        except _DEVICE_FAULTS:
            raise
        except Exception as e:
            rid = getattr(e, "request_id", None)
            hit = ([i for i in idxs if self.slots[i].request_id == rid]
                   if rid is not None else [])
            if hit:
                # attributed: finish the culprit, run the rest
                self._poison(self.slots[hit[0]], e, finished)
                recurse([i for i in idxs if i != hit[0]])
            elif len(idxs) == 1:
                self._poison(self.slots[idxs[0]], e, finished)
            else:
                mid = len(idxs) // 2
                recurse(idxs[:mid])
                recurse(idxs[mid:])
            return None

    def _decode_subset(self, idxs, finished):
        """One decode step with ``idxs`` active, with poison isolation
        (``_isolate``); book each slot's token."""
        if not idxs:
            return
        nxt = self._isolate(
            idxs, finished, self._launch_decode,
            lambda s: self._decode_subset(s, finished))
        if nxt is None:
            return
        cfg, st = self.config, self.stepstats
        for i in idxs:
            req = self.slots[i]
            req.num_cached += 1
            tok = int(nxt[i])
            req.output_token_ids.append(tok)
            req.last_token = tok
            self.metrics.decode_tokens += 1
            req.timeline.decode_tokens += 1
            if st is not None:
                st.note_decode(1)
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
        # a parked handle for a request that will never resume is dead
        # budget, in this engine's tier or a peer's: release it now
        # instead of waiting for the LRU
        drop_handle(req, self.spill)
        if reason == "aborted" and self.stepstats is not None:
            # the client walked away from every token this request
            # emitted: reclassify them useful -> wasted in the ledger
            self.stepstats.note_abort(len(req.output_token_ids))
        if reason in ("timeout", "error"):
            # degradation events belong in the postmortem ring; normal
            # completions would only drown them out
            _flight.record("serving", reason, engine=self.engine_id,
                           request_id=req.request_id, error=req.error)
        req.finish_reason = reason
        req.state = RequestState.FINISHED
        req.finish_time = time.perf_counter()
        # close the phase record, then the finish accounting: e2e/tpot
        # digests and the SLO window (client aborts excluded), the
        # access-log line and the flight timeline ring (aborts included)
        req.timeline.mark_finish(reason, req.finish_time)
        record_finish(
            req, latency=self.metrics.latency, slo=self.slo,
            access_log=self.access_log, engine=self.engine_id,
        )
        self._release(req)
        self.metrics.requests_finished += 1
        if self.journal is not None:
            # trailing tokens + terminal record, buffered; the step's
            # flush (the next one, for between-step aborts) makes the
            # completion durable
            self.journal.finish(req, reason)
        finished.append(RequestOutput(req))
