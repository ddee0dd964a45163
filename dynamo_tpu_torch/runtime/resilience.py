"""Unified resilience policy: retry with backoff + circuit breaker.

The port's copy of the reference package's runtime/resilience.py: one
implementation for every communication plane of the port (the TCP request
plane's connect, the netstore client, the runtime's lease re-acquire) and
for the serving plane's breakers (one per worker in llm/discovery.py, one
per model in the HTTP frontend), in two primitives:

- ``RetryPolicy``: bounded attempts, exponential backoff with decorrelated
  jitter (sleep_n = min(cap, U(base, 3 * sleep_{n-1}))), optional per-attempt
  timeout and total deadline, and a retryable-error predicate so terminal
  errors (typed 4xx-class failures) are never retried.
- ``CircuitBreaker``: closed/open/half-open with a sliding failure-rate
  window. An open circuit fails fast: ``allow()`` is false (the frontend
  answers 503 + Retry-After) and ``guard`` raises ``CircuitOpenError``;
  after ``reset_timeout_s`` a bounded number of half-open probes decides
  reopen vs close.

Both work sync and async, are configured through ``DTPU_RETRY_DEFAULT`` /
``DTPU_RETRY_<SCOPE>`` and ``DTPU_CB_DEFAULT`` / ``DTPU_CB_<SCOPE>`` (compact
``key=value,key=value`` specs), and export per-policy Prometheus series
through runtime/metrics.py: ``dtpu_retry_attempts_total`` /
``dtpu_retry_giveups_total`` and ``dtpu_circuit_state`` /
``dtpu_circuit_transitions_total``, labelled ``policy``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple, Type

from . import metrics as M
from .errors import is_terminal
from .logging import get_logger

log = get_logger("runtime.resilience")

# env spec prefixes
ENV_RETRY_PREFIX = "DTPU_RETRY_"
ENV_CB_PREFIX = "DTPU_CB_"

# transient transport-class failures; typed application errors (see
# runtime/errors.py) deliberately do NOT appear here
RETRYABLE_DEFAULT: Tuple[Type[BaseException], ...] = (
    ConnectionError,
    OSError,
    TimeoutError,
    asyncio.TimeoutError,  # distinct from builtin TimeoutError before py3.11
)


def _spec_dict(spec: Optional[str]) -> Dict[str, str]:
    """``"attempts=4,base=0.05"`` -> {"attempts": "4", "base": "0.05"}."""
    out: Dict[str, str] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        k, sep, v = part.partition("=")
        if not sep:
            raise ValueError(f"bad policy spec fragment {part!r} (want key=value)")
        out[k.strip()] = v.strip()
    return out


def _scope_env(prefix: str, scope: str) -> Dict[str, str]:
    """Layered spec: DTPU_<PREFIX>_DEFAULT overlaid by DTPU_<PREFIX>_<SCOPE>
    (scope dots/dashes become underscores: ``transfer.pull`` ->
    ``DTPU_RETRY_TRANSFER_PULL``)."""
    merged: Dict[str, str] = {}
    for name in ("DEFAULT", scope.upper().replace(".", "_").replace("-", "_")):
        raw = os.environ.get(prefix + name)
        if raw:
            try:
                merged.update(_spec_dict(raw))
            except ValueError as e:
                log.warning("ignoring bad %s%s: %s", prefix, name, e)
    return merged


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff + decorrelated jitter.

    ``seed`` pins the jitter schedule (chaos tests assert reproducibility);
    production policies leave it None. ``attempt_timeout_s`` only applies to
    the async path (a sync callable cannot be preempted)."""

    name: str = "default"
    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    attempt_timeout_s: Optional[float] = None
    deadline_s: Optional[float] = None
    retryable: Tuple[Type[BaseException], ...] = RETRYABLE_DEFAULT
    predicate: Optional[Callable[[BaseException], bool]] = None
    seed: Optional[int] = None
    metrics: Optional[M.MetricsScope] = None

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        scope = self.metrics if self.metrics is not None else _metrics_scope()
        self._retries = scope.counter(
            M.RETRY_ATTEMPTS_TOTAL, "retry attempts", extra_labels=("policy",)
        )
        self._giveups = scope.counter(
            M.RETRY_GIVEUPS_TOTAL, "retries exhausted", extra_labels=("policy",)
        )

    @classmethod
    def from_env(cls, scope: str, **defaults: Any) -> "RetryPolicy":
        """Policy for ``scope`` from the env catalog, over code defaults.
        Spec keys: attempts, base, max, timeout, deadline."""
        cfg = dict(defaults)
        cfg.setdefault("name", scope)
        spec = _scope_env(ENV_RETRY_PREFIX, scope)
        conv = {
            "attempts": ("max_attempts", int),
            "base": ("base_delay_s", float),
            "max": ("max_delay_s", float),
            "timeout": ("attempt_timeout_s", float),
            "deadline": ("deadline_s", float),
        }
        for key, (field, fn) in conv.items():
            if key in spec:
                try:
                    cfg[field] = fn(spec[key])
                except ValueError:
                    log.warning("bad %s=%r for retry scope %s", key, spec[key], scope)
        return cls(**cfg)

    # -- backoff schedule ----------------------------------------------------
    def is_retryable(self, exc: BaseException) -> bool:
        if self.predicate is not None:
            return bool(self.predicate(exc))
        # typed terminal errors (runtime/errors.py) never retry, even under
        # a broad retryable tuple like (Exception,): a 4xx-class failure or
        # an open circuit cannot be fixed by trying again
        if is_terminal(exc):
            return False
        return isinstance(exc, self.retryable)

    def next_delay(self, prev: Optional[float]) -> float:
        """Decorrelated jitter: min(cap, U(base, 3 * prev)); prev=None seeds
        the chain at base."""
        lo = self.base_delay_s
        hi = max(lo, 3.0 * (prev if prev is not None else lo))
        return min(self.max_delay_s, self._rng.uniform(lo, hi))

    def delays(self):
        """The full backoff schedule for one call (max_attempts - 1 sleeps)."""
        prev: Optional[float] = None
        for _ in range(max(0, self.max_attempts - 1)):
            prev = self.next_delay(prev)
            yield prev

    def _give_up(self, exc: BaseException, attempt: int, t0: float) -> bool:
        if not self.is_retryable(exc):
            return True
        if attempt >= self.max_attempts:
            return True
        if self.deadline_s is not None and time.monotonic() - t0 >= self.deadline_s:
            return True
        return False

    # -- execution -----------------------------------------------------------
    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        t0 = time.monotonic()
        prev: Optional[float] = None
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                if self._give_up(e, attempt, t0):
                    self._giveups.inc(policy=self.name)
                    raise
                prev = self.next_delay(prev)
                self._retries.inc(policy=self.name)
                log.debug(
                    "%s: attempt %d/%d failed (%s); retrying in %.3fs",
                    self.name, attempt, self.max_attempts, e, prev,
                )
                time.sleep(prev)

    async def acall(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        """Async variant; ``fn`` returns an awaitable. Per-attempt timeout is
        enforced with wait_for (a timed-out attempt counts as retryable)."""
        t0 = time.monotonic()
        prev: Optional[float] = None
        attempt = 0
        while True:
            attempt += 1
            try:
                aw = fn(*args, **kwargs)
                if self.attempt_timeout_s is not None:
                    return await asyncio.wait_for(aw, self.attempt_timeout_s)
                return await aw
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                if self._give_up(e, attempt, t0):
                    self._giveups.inc(policy=self.name)
                    raise
                prev = self.next_delay(prev)
                self._retries.inc(policy=self.name)
                log.debug(
                    "%s: attempt %d/%d failed (%s); retrying in %.3fs",
                    self.name, attempt, self.max_attempts, e, prev,
                )
                await asyncio.sleep(prev)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
_STATE_VALUE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitOpenError(ConnectionError):
    """Raised (or returned as busy-503 + Retry-After) when a circuit is open."""

    code = "circuit_open"

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(
            f"circuit {name!r} open; retry after {retry_after_s:.2f}s"
        )
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """closed/open/half-open breaker over a sliding failure-rate window.

    Trip condition: within ``window_s``, at least ``failure_threshold``
    failures AND a failure rate >= ``failure_rate``. Open rejects for
    ``reset_timeout_s``; then up to ``half_open_max`` concurrent probes run —
    a probe success closes, a probe failure reopens. Thread-safe (no await
    under the lock), so one instance serves sync and asyncio callers alike.
    """

    def __init__(
        self,
        name: str = "default",
        failure_threshold: int = 5,
        failure_rate: float = 0.5,
        window_s: float = 30.0,
        reset_timeout_s: float = 5.0,
        half_open_max: int = 1,
        metrics: Optional[M.MetricsScope] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.failure_threshold = failure_threshold
        self.failure_rate = failure_rate
        self.window_s = window_s
        self.reset_timeout_s = reset_timeout_s
        self.half_open_max = half_open_max
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._opened_at = 0.0
        self._half_open_inflight = 0
        self._events: Deque[Tuple[float, bool]] = deque()
        scope = metrics if metrics is not None else _metrics_scope()
        self._transitions = scope.counter(
            M.CIRCUIT_TRANSITIONS_TOTAL, "circuit state transitions",
            extra_labels=("policy", "state"),
        )
        self._state_g = scope.gauge(
            M.CIRCUIT_STATE, "circuit state (0 closed, 1 half-open, 2 open)",
            extra_labels=("policy",),
        )
        self._state_g.set(0.0, policy=name)

    @classmethod
    def from_env(cls, scope: str, **defaults: Any) -> "CircuitBreaker":
        """Breaker for ``scope`` from the env catalog. Spec keys: threshold,
        rate, window, reset, half_open."""
        cfg = dict(defaults)
        cfg.setdefault("name", scope)
        spec = _scope_env(ENV_CB_PREFIX, scope)
        conv = {
            "threshold": ("failure_threshold", int),
            "rate": ("failure_rate", float),
            "window": ("window_s", float),
            "reset": ("reset_timeout_s", float),
            "half_open": ("half_open_max", int),
        }
        for key, (field, fn) in conv.items():
            if key in spec:
                try:
                    cfg[field] = fn(spec[key])
                except ValueError:
                    log.warning("bad %s=%r for breaker scope %s", key, spec[key], scope)
        return cls(**cfg)

    # -- state machine -------------------------------------------------------
    def _transition(self, state: str) -> None:
        # lock held by caller
        if state == self._state:
            return
        log.info("circuit %s: %s -> %s", self.name, self._state, state)
        self._state = state
        self._transitions.inc(policy=self.name, state=state)
        self._state_g.set(_STATE_VALUE[state], policy=self.name)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.reset_timeout_s
        ):
            self._transition(HALF_OPEN)
            self._half_open_inflight = 0

    def allow(self) -> bool:
        """True when a call may proceed (and reserves a half-open probe slot)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            self._maybe_half_open()
            if self._state == OPEN:
                return False
            if self._half_open_inflight >= self.half_open_max:
                return False
            self._half_open_inflight += 1
            return True

    def retry_after_s(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(
                0.0, self.reset_timeout_s - (self._clock() - self._opened_at)
            )

    def record(self, ok: bool) -> None:
        with self._lock:
            now = self._clock()
            if self._state == HALF_OPEN:
                if self._half_open_inflight <= 0:
                    # a request admitted before the trip draining now: it is
                    # not the probe and must not drive the transition (a
                    # stale success would close the circuit with no probe
                    # ever reaching a worker)
                    return
                self._half_open_inflight -= 1
                if ok:
                    self._events.clear()
                    self._transition(CLOSED)
                else:
                    self._opened_at = now
                    self._transition(OPEN)
                return
            if self._state == OPEN:
                return  # stale result from before the trip
            self._events.append((now, ok))
            while self._events and now - self._events[0][0] > self.window_s:
                self._events.popleft()
            if ok:
                return
            fails = sum(1 for _, o in self._events if not o)
            if (
                fails >= self.failure_threshold
                and fails / len(self._events) >= self.failure_rate
            ):
                self._opened_at = now
                self._transition(OPEN)

    # -- wrappers ------------------------------------------------------------
    def guard(self) -> None:
        if not self.allow():
            raise CircuitOpenError(self.name, self.retry_after_s())

    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        self.guard()
        try:
            result = fn(*args, **kwargs)
        except BaseException:
            self.record(False)
            raise
        self.record(True)
        return result

    async def acall(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        self.guard()
        try:
            result = await fn(*args, **kwargs)
        except asyncio.CancelledError:
            self.record(True)  # caller went away; not a service failure
            raise
        except BaseException:
            self.record(False)
            raise
        self.record(True)
        return result


# ---------------------------------------------------------------------------
# process-local registries (planes share one policy instance per scope so the
# per-policy metrics aggregate; per-object breakers — e.g. one per worker —
# are constructed directly instead)
# ---------------------------------------------------------------------------

_registry_lock = threading.Lock()
_policies: Dict[str, RetryPolicy] = {}
_breakers: Dict[str, CircuitBreaker] = {}
_default_metrics: Optional[M.MetricsScope] = None


def _metrics_scope() -> M.MetricsScope:
    global _default_metrics
    if _default_metrics is None:
        _default_metrics = M.MetricsScope()
    return _default_metrics


def set_metrics_scope(scope: M.MetricsScope) -> None:
    """Route NEW policies'/breakers' metrics into ``scope`` (e.g. the
    DistributedRuntime's registry so /metrics exposes them)."""
    global _default_metrics
    _default_metrics = scope


def adopt_metrics_scope(scope: M.MetricsScope) -> None:
    """First caller wins: the first DistributedRuntime in a process donates
    its registry so shared policies' retry counters ride that process's
    /metrics instead of a detached private registry."""
    global _default_metrics
    if _default_metrics is None:
        _default_metrics = scope


def retry_policy(scope: str, **defaults: Any) -> RetryPolicy:
    with _registry_lock:
        p = _policies.get(scope)
        if p is None:
            p = _policies[scope] = RetryPolicy.from_env(scope, **defaults)
        return p


def circuit_breaker(scope: str, **defaults: Any) -> CircuitBreaker:
    with _registry_lock:
        b = _breakers.get(scope)
        if b is None:
            b = _breakers[scope] = CircuitBreaker.from_env(scope, **defaults)
        return b


def reset_registries() -> None:
    """Drop cached policies/breakers (tests; env spec changes)."""
    with _registry_lock:
        _policies.clear()
        _breakers.clear()
