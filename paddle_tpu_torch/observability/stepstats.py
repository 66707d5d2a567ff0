"""Serving step observatory: per-program step-time attribution,
occupancy/goodput accounting, and a live MFU estimate.

Counterpart of ``paddle_tpu/observability/stepstats.py`` (the same
sampler, ledger, series and views; the port keeps its own copy):

- ``Engine.step()`` drives one ``StepStats`` sampler per engine:
  ``begin_step()`` at the top, ``record_launch(program, wall)`` around
  each program launch, ``note_*`` attribute bumps as tokens are
  computed, and ``end_step(...)`` at the tail, which folds everything
  into a bounded per-step sample. Host overhead = step wall minus the
  sum of launch walls, recorded as the pseudo-program ``"host"``.
  The observatory adds no device sync and no launch: a launch wall is
  taken on the host clock around the launch, and it is device-inclusive
  exactly where the launch already ends in a read-back (decode, verify
  and a final prefill or chunk read their tokens back, the step's sync).
  A non-final chunk and a copy-on-write read nothing back, so their
  wall is the host's enqueue time; the device time they queue lands in
  the next launch that reads back.
- Per-program launch walls feed mergeable ``LatencyDigest`` sketches →
  ``paddle_tpu_serving_step_seconds{program,quantile}`` at scrape time.
- The goodput ledger separates USEFUL tokens (first-time prefill +
  emitted decode/verify tokens that reach a caller) from WASTED work:
  rejected speculation drafts, preemption-recompute tokens, migration
  re-prefill tokens, and tokens of aborted requests (reclassified from
  useful at abort). A "restored" resume cause (serving/spill.py wrote
  the victim's KV back from host memory instead of recomputing it)
  counts any residual prefill as useful. The reconciliation identities:

      useful + wasted_preempt + wasted_migration
             == prefill_tokens + decode_tokens - aborted
      wasted_spec == spec_proposed - spec_accepted

- MFU: achieved flops/s over the sample window divided by a peak table
  keyed by torch device type. Flops-per-token is the PaLM
  ``2 * N_params`` forward convention counted from the adapter's weight
  tree. The ``"cuda"`` row is the H100 SXM dense bf16 tensor-core peak;
  the ``"cpu"`` row is a round placeholder, so CPU MFU is a sanity
  signal, not a measurement.

Nothing here touches a program: every hot-path call is host-side
attribute arithmetic plus one ``LatencyDigest.record`` per launch, and
all rendering happens in the pull-time collector view (weakref — a dead
sampler's view unregisters itself). The engine wraps the sampler in the
``obs.stepstats`` fault site: a crashing sampler warns once and disables
itself, never perturbing the step.
"""
from __future__ import annotations

import time
import weakref
from collections import deque

from .latency import DEFAULT_QUANTILES, LatencyDigest

__all__ = [
    "LEDGER_CLASSES",
    "PEAK_FLOPS_PER_CHIP",
    "StepStats",
    "flops_per_token",
    "register_stepstats_view",
]

# Dense peak FLOP/s per chip by torch device type. "cuda" is the card the
# port targets, an H100 SXM: 989e12 dense bf16 on the tensor cores
# (NVIDIA's data sheet, at the 700 W power limit). "cpu" is a round
# smoke-test figure, so CPU MFU stays a plausibility check.
PEAK_FLOPS_PER_CHIP = {
    "cuda": 989e12,
    "cpu": 1e11,
}
# what each row is, as summary() names it
PEAK_SOURCES = {
    "cuda": "H100 SXM dense bf16 tensor-core peak",
    "cpu": "CPU placeholder",
}

# Goodput ledger classes, in export order (label value -> attr).
LEDGER_CLASSES = (
    ("useful", "useful_tokens"),
    ("spec_reject", "wasted_spec_tokens"),
    ("preempt_recompute", "wasted_preempt_tokens"),
    ("migration_reprefill", "wasted_migration_tokens"),
    ("aborted", "wasted_aborted_tokens"),
)


def _param_count(weights):
    """Total parameter count of an adapter weight tree: plain containers
    (dict/list/tuple) of tensors (``numel()``) or numpy arrays
    (``size``)."""
    total, stack = 0, [weights]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif hasattr(node, "numel"):
            total += int(node.numel())
        else:
            size = getattr(node, "size", None)
            if size is not None:
                total += int(size)
    return total


def flops_per_token(adapter):
    """Approximate forward FLOPs per computed token: ``2 * N_params``
    (the PaLM MFU convention — matmul dominates, attention's quadratic
    term ignored). None when the adapter exposes no sized weights."""
    weights = getattr(adapter, "weights", None)
    if weights is None:
        return None
    n = _param_count(weights)
    return 2.0 * n if n else None


class StepStats:
    """One engine's step observatory. Single-writer (the engine step
    loop); scrapes read plain attributes and digest snapshots, which is
    the same torn-read-tolerant contract as ``EngineMetrics``."""

    def __init__(self, adapter=None, ring=256):
        ring = int(ring)
        if ring < 1:
            raise ValueError(f"stepstats ring must be >= 1, got {ring}")
        # per-program launch-wall digests (seconds), created lazily so
        # programs that never ran export nothing; "host" holds the
        # per-step host-overhead split
        self.digests: dict = {}
        self.samples: deque = deque(maxlen=ring)
        self.flops_per_token = (
            flops_per_token(adapter) if adapter is not None else None
        )
        # the device type the adapter runs on ("cuda", "cpu")
        device = getattr(adapter, "device", None)
        backend = getattr(device, "type", None) or (
            str(device).split(":")[0] if device is not None else "cpu")
        row = backend if backend in PEAK_FLOPS_PER_CHIP else "cpu"
        self.backend = backend
        self.peak_flops_per_chip = PEAK_FLOPS_PER_CHIP[row]
        self.peak_source = PEAK_SOURCES[row]
        # goodput ledger (host-side ints, bumped by the engine hot path)
        self.useful_tokens = 0
        self.wasted_spec_tokens = 0
        self.wasted_preempt_tokens = 0
        self.wasted_migration_tokens = 0
        self.wasted_aborted_tokens = 0
        # last-step gauges the collector view exports
        self.last_occupancy = 0.0
        self.last_queue_depth = 0
        # in-flight step state
        self._t0 = None
        self._launches: list = []
        self._step_tokens = 0

    # ----- hot path (engine step loop) --------------------------------

    def begin_step(self):
        self._t0 = time.perf_counter()
        self._launches = []
        self._step_tokens = 0

    def record_launch(self, program, wall_s):
        """One device launch of ``program`` took ``wall_s`` seconds
        wall (device-inclusive: the engine's timer spans the host
        sync)."""
        d = self.digests.get(program)
        if d is None:
            d = self.digests[program] = LatencyDigest()
        d.record(wall_s)
        self._launches.append((program, wall_s))

    def note_prefill(self, n, cause=None):
        """``n`` prompt tokens computed by a prefill launch. ``cause``
        None = first-time (useful); "restored" = residual prefill after
        a host-spill restore rebuilt the context for free (useful — the
        restore made the recompute unnecessary); "preempt"/"migration"
        = recompute of already-produced context (wasted)."""
        if cause is None or cause == "restored":
            self.useful_tokens += n
        elif cause == "migration":
            self.wasted_migration_tokens += n
        else:
            self.wasted_preempt_tokens += n
        self._step_tokens += n

    def note_decode(self, n):
        """``n`` output tokens emitted (decode or accepted-verify)."""
        self.useful_tokens += n
        self._step_tokens += n

    def note_spec_reject(self, n):
        """``n`` speculative draft tokens the verify launch computed
        and rejected."""
        self.wasted_spec_tokens += n
        self._step_tokens += n

    def note_abort(self, n):
        """An aborted request discards ``n`` already-emitted tokens:
        reclassify them useful -> wasted (no new compute happened)."""
        self.useful_tokens -= n
        self.wasted_aborted_tokens += n

    def end_step(self, occupancy=0.0, queue_depth=0, kv_free_blocks=0,
                 kv_reclaimable_blocks=0):
        """Fold the step into a bounded sample. Idle steps (no launch,
        no token, empty batch+queue) only refresh the gauges — they
        carry no attribution and would flush real samples out of the
        ring; the wall-clock gap they represent still reaches the MFU
        window through sample timestamps."""
        self.last_occupancy = occupancy
        self.last_queue_depth = queue_depth
        t0, self._t0 = self._t0, None
        launches, self._launches = self._launches, []
        tokens, self._step_tokens = self._step_tokens, 0
        if not launches and not tokens and not queue_depth \
                and not occupancy:
            return None
        wall = 0.0 if t0 is None else time.perf_counter() - t0
        host = max(wall - sum(w for _, w in launches), 0.0)
        if launches:
            d = self.digests.get("host")
            if d is None:
                d = self.digests["host"] = LatencyDigest()
            d.record(host)
        sample = {
            "ts": time.time(),
            "wall_ms": wall * 1e3,
            "host_ms": host * 1e3,
            "launches": [(p, w * 1e3) for p, w in launches],
            "tokens": tokens,
            "occupancy": occupancy,
            "queue_depth": queue_depth,
            "kv_free_blocks": kv_free_blocks,
            "kv_reclaimable_blocks": kv_reclaimable_blocks,
            "kv_headroom_blocks": kv_free_blocks + kv_reclaimable_blocks,
        }
        self.samples.append(sample)
        return sample

    # ----- pull-time views ---------------------------------------------

    @property
    def wasted_tokens(self):
        return (self.wasted_spec_tokens + self.wasted_preempt_tokens
                + self.wasted_migration_tokens
                + self.wasted_aborted_tokens)

    def goodput_fraction(self):
        """useful / (useful + wasted); 1.0 before any work (an idle
        engine wastes nothing)."""
        useful = max(self.useful_tokens, 0)
        total = useful + self.wasted_tokens
        return useful / total if total else 1.0

    def mfu(self, now=None):
        """Live model-flops-utilization over the sample window: tokens
        computed (useful AND wasted — MFU measures chip work, goodput
        discounts it) times flops-per-token, over the window span,
        against one card's per-device-type peak (an engine runs on one
        card). None until a sample exists or when the adapter exposes no
        weights."""
        if self.flops_per_token is None or not self.samples:
            return None
        now = time.time() if now is None else now
        span = max(now - self.samples[0]["ts"], 1e-6)
        toks = sum(s["tokens"] for s in self.samples)
        return toks * self.flops_per_token / span / self.peak_flops_per_chip

    def ledger(self):
        return {cls: getattr(self, attr) for cls, attr in LEDGER_CLASSES}

    def summary(self):
        """health()-shaped view: per-program step walls (ms), goodput
        ledger, occupancy, MFU."""
        step_ms = {}
        for prog in sorted(self.digests):
            d = self.digests[prog]
            if not d.count:
                continue
            step_ms[prog] = {
                "p50": d.quantile(0.5) * 1e3,
                "p99": d.quantile(0.99) * 1e3,
                "mean": d.mean * 1e3,
                "count": d.count,
            }
        return {
            "goodput_fraction": self.goodput_fraction(),
            "mfu": self.mfu(),
            "occupancy": self.last_occupancy,
            "tokens": self.ledger(),
            "step_ms": step_ms,
            "samples": len(self.samples),
            "backend": self.backend,
            "flops_per_token": self.flops_per_token,
            "peak_flops_per_chip": self.peak_flops_per_chip,
            "peak_source": self.peak_source,
        }


def register_stepstats_view(stats, engine_id, registry=None):
    """Register the pull-time collector for one sampler: step-time
    quantiles per program, occupancy, goodput fraction + ledger, and
    MFU, all labeled ``engine=<id>``. Weakref idiom — when the engine
    drops its sampler (GC or ``obs.stepstats`` degradation) the view
    returns None and the registry unregisters it."""
    from .metrics import MetricFamily, get_registry

    reg = registry if registry is not None else get_registry()
    ref = weakref.ref(stats)
    label = {"engine": engine_id}

    def collect():
        st = ref()
        if st is None:
            return None
        fams = []
        steps = MetricFamily(
            "paddle_tpu_serving_step_seconds", "summary",
            "serving launch wall time by program (host = per-step "
            "host overhead)",
        )
        for prog in sorted(st.digests):
            d = st.digests[prog]
            counts, count, total, _ = d.snapshot()
            if not count:
                continue
            pl = {**label, "program": prog}
            for q in DEFAULT_QUANTILES:
                steps.add(d.quantile(q), {**pl, "quantile": f"{q:g}"})
            steps.add(total, pl, "_sum")
            steps.add(count, pl, "_count")
        if steps.samples:
            fams.append(steps)
        fams.append(MetricFamily(
            "paddle_tpu_serving_occupancy", "gauge",
            "active slots / max_batch_slots at the last step",
        ).add(st.last_occupancy, label))
        fams.append(MetricFamily(
            "paddle_tpu_serving_goodput_fraction", "gauge",
            "useful tokens / all computed tokens",
        ).add(st.goodput_fraction(), label))
        tokens = MetricFamily(
            "paddle_tpu_serving_goodput_tokens_total", "counter",
            "token work by goodput class",
        )
        for cls, attr in LEDGER_CLASSES:
            tokens.add(getattr(st, attr), {**label, "class": cls})
        fams.append(tokens)
        mfu = st.mfu()
        if mfu is not None:
            fams.append(MetricFamily(
                "paddle_tpu_serving_mfu", "gauge",
                "model flops utilization over the sample window "
                "(per-device-type peak table; CPU entry is a placeholder)",
            ).add(mfu, label))
        return fams

    name = f"serving.stepstats.{engine_id}"
    reg.register_collector(name, collect)
    return name
