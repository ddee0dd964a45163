"""The port's resilience policy (dynamo_tpu_torch/runtime/resilience.py)
against the reference's (dynamo_tpu/runtime/resilience.py).

Each case of tests/test_resilience.py runs on the port: retry backoff,
jitter and predicates sync and async, per-attempt timeouts and deadlines,
the ``DTPU_RETRY_*`` / ``DTPU_CB_*`` specs, the registries, the breaker's
closed / open / half-open machine and the Prometheus series. Then the two
packages side by side: a seeded policy's ``delays()`` schedule, and one
breaker per package fed the same seeded allow / record / clock sequence,
whose states, grants, ``retry_after_s`` and transition counts must be
equal at every step.
"""

import asyncio
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime import metrics as JM
from dynamo_tpu.runtime import resilience as jres
from dynamo_tpu_torch.runtime import metrics as M
from dynamo_tpu_torch.runtime import resilience as res
from dynamo_tpu_torch.runtime.errors import InvalidRequestError, is_terminal
from dynamo_tpu_torch.runtime.resilience import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
    CircuitOpenError,
    RetryPolicy,
    circuit_breaker,
    reset_registries,
    retry_policy,
)


def _policy(**kw):
    kw.setdefault("name", "test")
    kw.setdefault("base_delay_s", 0.001)
    kw.setdefault("max_delay_s", 0.01)
    return RetryPolicy(**kw)


# -- RetryPolicy (tests/test_resilience.py) ----------------------------------

def test_retry_sync_succeeds_after_transient_failures():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("blip")
        return "ok"

    assert _policy(max_attempts=5).call(flaky) == "ok"
    assert calls["n"] == 3


def test_retry_sync_exhausts_and_reraises():
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise ConnectionError("down")

    with pytest.raises(ConnectionError):
        _policy(max_attempts=3).call(always)
    assert calls["n"] == 3


def test_terminal_errors_never_retry():
    calls = {"n": 0}

    def invalid():
        calls["n"] += 1
        raise InvalidRequestError("bad grammar")

    with pytest.raises(InvalidRequestError):
        _policy(max_attempts=5).call(invalid)
    assert calls["n"] == 1  # not retryable: one attempt only
    assert is_terminal(InvalidRequestError("x"))
    assert not is_terminal(ConnectionError("x"))
    # an open circuit is terminal too: retrying cannot close it
    assert is_terminal(CircuitOpenError("c", 1.0))


def test_custom_predicate_wins():
    calls = {"n": 0}

    def fail():
        calls["n"] += 1
        raise ValueError("retry me anyway")

    p = _policy(max_attempts=3, predicate=lambda e: isinstance(e, ValueError))
    with pytest.raises(ValueError):
        p.call(fail)
    assert calls["n"] == 3


def test_backoff_is_decorrelated_jitter_within_bounds():
    p = _policy(max_attempts=10, base_delay_s=0.05, max_delay_s=0.4, seed=3)
    prev = None
    for d in p.delays():
        lo = p.base_delay_s
        hi = min(p.max_delay_s, 3.0 * (prev if prev is not None else lo))
        assert lo <= d <= max(lo, hi)
        prev = d


def test_backoff_deterministic_with_seed():
    a = list(_policy(max_attempts=8, seed=42).delays())
    b = list(_policy(max_attempts=8, seed=42).delays())
    c = list(_policy(max_attempts=8, seed=43).delays())
    assert a == b
    assert a != c


async def test_retry_async_with_attempt_timeout():
    calls = {"n": 0}

    async def slow_then_fast():
        calls["n"] += 1
        if calls["n"] == 1:
            await asyncio.sleep(5.0)  # would blow the attempt timeout
        return "ok"

    p = _policy(max_attempts=3, attempt_timeout_s=0.05)
    assert await p.acall(slow_then_fast) == "ok"
    assert calls["n"] == 2


async def test_retry_async_deadline_caps_total():
    calls = {"n": 0}

    async def always():
        calls["n"] += 1
        await asyncio.sleep(0.03)
        raise ConnectionError("down")

    p = _policy(max_attempts=50, deadline_s=0.05)
    with pytest.raises(ConnectionError):
        await p.acall(always)
    assert calls["n"] < 10  # the deadline, not max_attempts, stopped it


def test_retry_env_spec_overrides(monkeypatch):
    monkeypatch.setenv("DTPU_RETRY_DEFAULT", "attempts=7,base=0.5")
    monkeypatch.setenv("DTPU_RETRY_TRANSFER_PULL", "attempts=2")
    p = RetryPolicy.from_env("transfer.pull", max_attempts=3, max_delay_s=9.0)
    assert p.max_attempts == 2          # the scope overrides the default
    assert p.base_delay_s == 0.5        # the default layer applies
    assert p.max_delay_s == 9.0         # a code default survives
    reset_registries()


def test_bad_env_specs_are_ignored(monkeypatch):
    monkeypatch.setenv("DTPU_RETRY_DEFAULT", "attempts")          # no '='
    monkeypatch.setenv("DTPU_CB_FRONTEND", "threshold=x,reset=0.5")  # bad value
    assert RetryPolicy.from_env("s", max_attempts=4).max_attempts == 4
    cb = CircuitBreaker.from_env("frontend", failure_threshold=9)
    assert cb.failure_threshold == 9 and cb.reset_timeout_s == 0.5


def test_registry_caches_per_scope():
    reset_registries()
    a = retry_policy("scope.a", max_attempts=4)
    assert retry_policy("scope.a") is a
    assert retry_policy("scope.b") is not a
    reset_registries()


# -- CircuitBreaker ----------------------------------------------------------

def _breaker(**kw):
    kw.setdefault("name", "cb-test")
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("window_s", 10.0)
    kw.setdefault("reset_timeout_s", 60.0)
    return CircuitBreaker(**kw)


def test_breaker_trips_after_threshold_failures():
    t = [0.0]
    cb = _breaker(clock=lambda: t[0])
    assert cb.state == CLOSED
    for _ in range(2):
        cb.record(False)
    assert cb.state == CLOSED  # below the threshold
    cb.record(False)
    assert cb.state == OPEN
    assert not cb.allow()
    assert cb.retry_after_s() > 0


def test_breaker_failure_rate_guard():
    # 3 failures among 17 successes: the volume is there, the rate too low
    cb = _breaker(failure_rate=0.5)
    for _ in range(17):
        cb.record(True)
    for _ in range(3):
        cb.record(False)
    assert cb.state == CLOSED


def test_breaker_window_expires_old_failures():
    t = [0.0]
    cb = _breaker(clock=lambda: t[0], window_s=5.0)
    cb.record(False)
    cb.record(False)
    t[0] = 6.0  # the old failures age out of the window
    cb.record(False)
    assert cb.state == CLOSED


def test_breaker_half_open_probe_closes_on_success():
    t = [0.0]
    cb = _breaker(clock=lambda: t[0], reset_timeout_s=5.0)
    for _ in range(3):
        cb.record(False)
    assert cb.state == OPEN
    t[0] = 5.1
    assert cb.state == HALF_OPEN
    assert cb.allow()          # the single probe slot
    assert not cb.allow()      # a concurrent second call is refused
    cb.record(True)
    assert cb.state == CLOSED
    assert cb.allow()


def test_breaker_half_open_probe_reopens_on_failure():
    t = [0.0]
    cb = _breaker(clock=lambda: t[0], reset_timeout_s=5.0)
    for _ in range(3):
        cb.record(False)
    t[0] = 5.1
    assert cb.allow()
    cb.record(False)
    assert cb.state == OPEN
    t[0] = 5.2
    assert not cb.allow()  # a fresh reset window started


def test_breaker_ignores_stale_results_in_half_open():
    t = [0.0]
    cb = _breaker(clock=lambda: t[0], reset_timeout_s=5.0)
    for _ in range(3):
        cb.record(False)
    t[0] = 5.1
    assert cb.state == HALF_OPEN
    cb.record(True)   # admitted before the trip, no probe slot reserved
    assert cb.state == HALF_OPEN


def test_breaker_guard_raises_typed_error():
    cb = _breaker(failure_threshold=1)
    cb.record(False)
    with pytest.raises(CircuitOpenError) as ei:
        cb.guard()
    assert ei.value.retry_after_s > 0
    assert ei.value.code == "circuit_open"
    assert isinstance(ei.value, ConnectionError)


async def test_breaker_acall_wraps_outcomes():
    cb = _breaker(failure_threshold=2)

    async def boom():
        raise ConnectionError("x")

    for _ in range(2):
        with pytest.raises(ConnectionError):
            await cb.acall(boom)
    assert cb.state == OPEN
    with pytest.raises(CircuitOpenError):
        await cb.acall(boom)


def test_breaker_call_wraps_outcomes():
    cb = _breaker(failure_threshold=2)
    assert cb.call(lambda: 5) == 5
    for _ in range(2):
        with pytest.raises(ZeroDivisionError):
            cb.call(lambda: 1 / 0)
    assert cb.state == OPEN   # 2 failures of 3: >= the rate and the threshold
    with pytest.raises(CircuitOpenError):
        cb.call(lambda: 5)


def test_breaker_env_spec(monkeypatch):
    monkeypatch.setenv("DTPU_CB_FRONTEND", "threshold=2,reset=0.25,window=3")
    cb = CircuitBreaker.from_env("frontend", failure_threshold=9)
    assert cb.failure_threshold == 2
    assert cb.reset_timeout_s == 0.25
    assert cb.window_s == 3.0
    reset_registries()


def test_breaker_metrics_exported():
    scope = M.MetricsScope()
    cb = CircuitBreaker(
        "metrics-cb", failure_threshold=1, reset_timeout_s=60.0, metrics=scope
    )
    cb.record(False)
    text = scope.expose().decode()
    assert M.CIRCUIT_TRANSITIONS_TOTAL in text
    assert 'policy="metrics-cb"' in text
    assert 'state="open"' in text
    assert M.CIRCUIT_STATE in text
    assert (M.CIRCUIT_STATE, M.CIRCUIT_TRANSITIONS_TOTAL) == (
        JM.CIRCUIT_STATE, JM.CIRCUIT_TRANSITIONS_TOTAL)


def test_retry_metrics_exported():
    scope = M.MetricsScope()
    p = RetryPolicy(
        name="metrics-retry", max_attempts=2, base_delay_s=0.001,
        max_delay_s=0.002, metrics=scope,
    )
    with pytest.raises(ConnectionError):
        p.call(lambda: (_ for _ in ()).throw(ConnectionError("x")))
    text = scope.expose().decode()
    assert M.RETRY_ATTEMPTS_TOTAL in text
    assert M.RETRY_GIVEUPS_TOTAL in text
    assert 'policy="metrics-retry"' in text


def test_breaker_registry_caches():
    reset_registries()
    assert circuit_breaker("x") is circuit_breaker("x")
    reset_registries()


def test_runtime_exports_and_scope_adoption():
    from dynamo_tpu_torch import runtime

    assert (runtime.CircuitBreaker, runtime.CircuitOpenError, runtime.RetryPolicy) == (
        CircuitBreaker, CircuitOpenError, RetryPolicy)
    saved = res._default_metrics
    try:
        res._default_metrics = None
        first, second = M.MetricsScope(), M.MetricsScope()
        res.adopt_metrics_scope(first)
        res.adopt_metrics_scope(second)   # the first caller wins
        assert res._metrics_scope() is first
        res.set_metrics_scope(second)     # set overrides
        assert res._metrics_scope() is second
    finally:
        res._default_metrics = saved


# -- side by side with the reference ------------------------------------------

@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), attempts=st.integers(1, 12),
       base=st.floats(0.001, 0.5), cap=st.floats(0.01, 5.0))
def test_seeded_delays_equal_the_reference(seed, attempts, base, cap):
    kw = dict(name="p", max_attempts=attempts, base_delay_s=base, max_delay_s=cap,
              seed=seed)
    assert list(RetryPolicy(**kw).delays()) == list(jres.RetryPolicy(**kw).delays())


@pytest.mark.parametrize("fails", [0, 1, 3, 5])
def test_retry_attempts_and_series_equal_the_reference(fails, monkeypatch):
    """The same failing callable under both packages' policies: the same
    attempts, the same sleeps, the same counter samples."""
    out = []
    for mod, mmod in ((res, M), (jres, JM)):
        sleeps, calls = [], []
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)
        scope = mmod.MetricsScope()
        p = mod.RetryPolicy(name="side", max_attempts=4, base_delay_s=0.05,
                            max_delay_s=1.0, seed=3, metrics=scope)

        def fn():
            calls.append(1)
            if len(calls) <= fails:
                raise ConnectionError("down")
            return "ok"

        try:
            got = p.call(fn)
        except ConnectionError:
            got = "raised"
        lines = sorted(ln for ln in scope.expose().decode().splitlines()
                       if ln.startswith("dtpu_retry") and "_created" not in ln
                       and not ln.startswith("#"))
        out.append((got, len(calls), sleeps, lines))
    assert out[0] == out[1]


def _breaker_trace(mod, mmod, ops, **kw):
    t = [0.0]
    scope = mmod.MetricsScope()
    cb = mod.CircuitBreaker(name="side", clock=lambda: t[0], metrics=scope, **kw)
    trace = []
    for op, arg in ops:
        if op == "tick":
            t[0] += arg
        elif op == "allow":
            trace.append(("allow", cb.allow()))
        else:
            cb.record(arg)
        trace.append((cb.state, round(cb.retry_after_s(), 9)))
    samples = sorted(ln for ln in scope.expose().decode().splitlines()
                     if ln.startswith("dtpu_circuit") and "_created" not in ln)
    return trace, samples


def _ops(seed: int, n: int) -> list:
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.25:
            ops.append(("tick", rng.choice((0.1, 0.5, 1.0, 2.5))))
        elif r < 0.5:
            ops.append(("allow", None))
        else:
            ops.append(("record", rng.random() < 0.4))
    return ops


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 120),
       threshold=st.integers(1, 6), rate=st.floats(0.1, 1.0),
       window=st.floats(0.5, 10.0), reset=st.floats(0.2, 5.0), half_open=st.integers(1, 3))
def test_breaker_sequences_equal_the_reference(seed, n, threshold, rate, window, reset,
                                               half_open):
    kw = dict(failure_threshold=threshold, failure_rate=rate, window_s=window,
              reset_timeout_s=reset, half_open_max=half_open)
    ops = _ops(seed, n)
    assert _breaker_trace(res, M, ops, **kw) == _breaker_trace(jres, JM, ops, **kw)


def test_a_fixed_sequence_trips_probes_and_closes_in_both():
    ops = ([("record", False)] * 5 + [("allow", None), ("tick", 2.1), ("allow", None),
                                      ("allow", None), ("record", True), ("allow", None)])
    kw = dict(failure_threshold=5, failure_rate=0.5, window_s=10.0, reset_timeout_s=2.0)
    port, ref = _breaker_trace(res, M, ops, **kw), _breaker_trace(jres, JM, ops, **kw)
    assert port == ref
    states = [s for s, _ in port[0] if s in (CLOSED, OPEN, HALF_OPEN)]
    assert states[4] == OPEN and HALF_OPEN in states and states[-1] == CLOSED
    moved = [ln for ln in port[1] if "transitions_total" in ln]
    assert len(moved) == 3 and all(ln.endswith(" 1.0") for ln in moved)
    assert [ln.split('state="')[1].split('"')[0] for ln in moved] == [
        "closed", "half_open", "open"]
