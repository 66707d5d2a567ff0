"""Retry policy: exponential backoff + jitter + deadline (counterpart of
``paddle_tpu/resilience/retry.py``, the same policy, delays and counter).
The serving fleet's replica supervisor rebuilds a dead replica under one.
Semantics:

  * attempt 1 runs immediately; attempt k sleeps
    ``min(base * multiplier**(k-2), max_delay) * (1 ± jitter)`` first
  * only exceptions in ``retry_on`` are retried — anything else
    propagates immediately (a server-side error is not a transient)
  * the overall ``deadline`` (seconds of wall clock from the first
    attempt) caps total time: once exceeded, the last exception is
    re-raised even if attempts remain
  * ``max_attempts=None`` retries until the deadline alone

Jitter is drawn from ``random.Random(seed)`` when a seed is given, so
tests are deterministic; ``sleep`` is injectable for zero-wall-clock
tests.
"""
from __future__ import annotations

import random
import time

__all__ = ["RetryPolicy", "retry_call"]


class RetryPolicy:
    def __init__(self, max_attempts=5, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.1, deadline=None,
                 retry_on=(ConnectionError, TimeoutError, OSError),
                 seed=None, sleep=time.sleep, clock=time.monotonic):
        if max_attempts is not None and max_attempts < 1:
            raise ValueError("max_attempts must be >= 1 or None")
        if max_attempts is None and deadline is None:
            raise ValueError(
                "unbounded retries need a deadline (max_attempts=None "
                "requires deadline)"
            )
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.max_attempts = max_attempts
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.retry_on = tuple(retry_on)
        self._rng = random.Random(seed) if seed is not None else random
        self._sleep = sleep
        self._clock = clock

    def delay(self, attempt):
        """Backoff before attempt number ``attempt`` (2-indexed: the
        first retry)."""
        d = min(
            self.base_delay * self.multiplier ** (attempt - 2),
            self.max_delay,
        )
        if self.jitter:
            d *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, d)

    def pause(self, attempt):
        """Sleep this policy's backoff for ``attempt`` (2-indexed like
        :meth:`delay`) — for call sites that own their loop but want
        the policy's backoff curve. Returns the seconds slept."""
        d = self.delay(attempt)
        self._sleep(d)
        return d

    def call(self, fn, *args, on_retry=None, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy. ``on_retry``
        (exc, attempt) is invoked before each backoff sleep — call sites
        use it to reset connections."""
        start = self._clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                out_of_attempts = (
                    self.max_attempts is not None
                    and attempt >= self.max_attempts
                )
                pause = self.delay(attempt + 1)
                past_deadline = (
                    self.deadline is not None
                    and self._clock() - start + pause > self.deadline
                )
                if out_of_attempts or past_deadline:
                    raise
                _count_retry(fn, e)
                if on_retry is not None:
                    on_retry(e, attempt)
                self._sleep(pause)


def _count_retry(fn, exc):
    """Telemetry: every retried attempt lands in
    ``paddle_tpu_resilience_retries_total{fn,exc}`` — a fleet whose
    coordination plane is silently retrying its way through flakiness
    should show it on a dashboard before it becomes an outage. Lazy
    import (retry loads before observability in the package graph) and
    best-effort: counting must never break the retry."""
    try:
        from ..observability import metrics

        metrics.counter(
            "paddle_tpu_resilience_retries_total",
            "retried attempts under RetryPolicy", ("fn", "exc"),
        ).inc(
            fn=getattr(fn, "__name__", "call"),
            exc=type(exc).__name__,
        )
    except Exception:
        # analysis: allow(broad-except) telemetry is best-effort; the
        # backoff/retry semantics must be unaffected by a counting failure
        pass


def retry_call(fn, *args, policy=None, **kwargs):
    """Convenience: run under ``policy`` (or a default RetryPolicy)."""
    return (policy or RetryPolicy()).call(fn, *args, **kwargs)
