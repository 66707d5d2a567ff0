"""The port's ``resilience.RetryPolicy`` against the JAX package's, the
cases of ``tests/test_resilience.py::TestRetryPolicy``: under the same
seed the two give the same delay sequence (jitter from a seeded
``random.Random``) and the same ``call`` outcomes (return value, attempts,
sleeps, the exception) for a retryable failure that clears, a
non-retryable one, exhaustion, a deadline, and the ``on_retry`` hook;
validation raises the same errors; each retried attempt is counted in
``paddle_tpu_resilience_retries_total{fn,exc}``.
"""
import pytest

from paddle_tpu.resilience import RetryPolicy as JaxRetryPolicy
from paddle_tpu_torch.resilience import RetryPolicy, retry_call

POLICIES = {"jax": JaxRetryPolicy, "port": RetryPolicy}


def _both(run):
    got = {name: run(cls) for name, cls in POLICIES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _drive(cls, fail_times, exc, **kw):
    """``policy.call`` over a function that raises ``exc`` its first
    ``fail_times`` calls: (result or exception repr, calls, sleeps, hook
    calls)."""
    sleeps, calls, hooks = [], [], []
    policy = cls(sleep=sleeps.append, **kw)

    def flaky():
        calls.append(1)
        if len(calls) <= fail_times:
            raise exc
        return "ok"

    try:
        out = policy.call(flaky,
                          on_retry=lambda e, n: hooks.append((repr(e), n)))
    except Exception as e:
        out = repr(e)
    return out, len(calls), sleeps, hooks


@pytest.mark.parametrize("seed", [0, 9, 1234])
@pytest.mark.parametrize("jitter", [0.0, 0.1, 0.5, 1.0])
def test_delay_sequence_matches_jax(seed, jitter):
    def run(cls):
        p = cls(jitter=jitter, base_delay=0.05, max_delay=2.0,
                multiplier=3.0, seed=seed)
        return [p.delay(a) for a in range(2, 12)]

    delays = _both(run)
    assert all(d >= 0.0 for d in delays)


@pytest.mark.parametrize("case,fail_times,exc,kw", [
    ("retryable_clears", 2, ConnectionError("drop"),
     dict(max_attempts=5, base_delay=0.1, jitter=0.0)),
    ("retryable_clears_jittered", 3, TimeoutError("slow"),
     dict(max_attempts=5, base_delay=0.1, jitter=0.3, seed=5)),
    ("non_retryable", 9, KeyError("not transient"),
     dict(max_attempts=5)),
    ("exhausted", 9, ConnectionError("always"),
     dict(max_attempts=3, base_delay=0.01, seed=1)),
    ("restart_policy", 9, OSError("no host"),
     dict(max_attempts=3, base_delay=0.05, max_delay=0.5,
          retry_on=(Exception,), seed=0)),
], ids=lambda v: v if isinstance(v, str) else None)
def test_call_outcomes_match_jax(case, fail_times, exc, kw):
    out, calls, sleeps, hooks = _both(
        lambda cls: _drive(cls, fail_times, exc, **kw))
    if case.startswith("retryable"):
        assert out == "ok" and calls == fail_times + 1
        assert len(sleeps) == len(hooks) == fail_times
        assert [n for _, n in hooks] == list(range(1, fail_times + 1))
    elif case == "non_retryable":
        assert calls == 1 and not sleeps and not hooks
    else:
        assert out == repr(exc) and calls == kw["max_attempts"]
        assert len(sleeps) == kw["max_attempts"] - 1


def test_deadline_caps_total_time():
    def run(cls):
        t = [0.0]
        sleeps = []

        def sleep(s):
            sleeps.append(s)
            t[0] += s

        policy = cls(max_attempts=None, base_delay=1.0, max_delay=1.0,
                     jitter=0.0, deadline=2.5, sleep=sleep,
                     clock=lambda: t[0])
        with pytest.raises(TimeoutError):
            policy.call(lambda: (_ for _ in ()).throw(TimeoutError()))
        return sleeps

    assert _both(run) == [1.0, 1.0]   # a third 1 s pause passes 2.5 s


def test_pause_and_retry_call():
    def run(cls):
        slept = []
        p = cls(base_delay=0.2, jitter=0.0, sleep=slept.append)
        return p.pause(3), slept

    assert _both(run) == (0.4, [0.4])
    assert retry_call(lambda x: x + 1, 1) == 2


@pytest.mark.parametrize("kw,needle", [
    (dict(max_attempts=0), "max_attempts"),
    (dict(max_attempts=None), "deadline"),
    (dict(jitter=1.5), "jitter"),
])
def test_validation_as_jax(kw, needle):
    for cls in POLICIES.values():
        with pytest.raises(ValueError, match=needle):
            cls(**kw)


def test_retries_are_counted():
    from paddle_tpu_torch.observability import get_registry

    def key():
        return ("paddle_tpu_resilience_retries_total"
                "{exc=ConnectionError,fn=flaky}")

    before = get_registry().snapshot().get(key(), 0)
    _drive(RetryPolicy, 2, ConnectionError("drop"), max_attempts=5,
           base_delay=0.0)
    assert get_registry().snapshot()[key()] == before + 2
