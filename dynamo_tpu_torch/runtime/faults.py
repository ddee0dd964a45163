"""Deterministic fault-injection plane.

The port's copy of the reference package's runtime/faults.py: a
process-local registry of named fault points threaded through the
communication planes and the engine loop, armed from ``DTPU_FAULTS`` so a
chaos drill can *provoke* the failures the resilience layer
(runtime/resilience.py) must absorb, reproducibly: probabilistic rules draw
from a seeded schedule keyed on the point's call index, never on wall time.

Spec grammar (``DTPU_FAULTS``, ``;``-separated rules)::

    point:action[=value][@qualifier[@qualifier...]]

    actions     fail          raise FaultInjected (typed application error)
                drop          raise InjectedDrop (a ConnectionError: looks
                              like transport loss to retry/migration)
                delay=S       sleep S seconds, then proceed
                hang=S        alias of delay for long stalls (watchdog tests)
                corrupt       flip payload bytes (sites that call mangle())
    qualifiers  @N            fire on the Nth call only (1-based)
                @N+           fire on the Nth call and every call after
                @p=0.3        fire each call with probability 0.3
                @seed=7       seed the probabilistic schedule (implies
                              p=0.5 when @p is absent); same seed => same
                              schedule
                (none)        fire on every call

Examples::

    DTPU_FAULTS="request_plane.send:drop@p=0.25@seed=11"
    DTPU_FAULTS="request_plane.send:drop@1;request_plane.send:drop@2"
    DTPU_FAULTS="engine.step:fail@40"

The port wires ``request_plane.connect`` / ``request_plane.send`` (the TCP
client), ``event_plane.publish`` (the in-process plane and the broker
plane, tcp_plane.py, with ``mangle``), ``discovery.call`` (the netstore
client), ``discovery.lease_keepalive`` (the runtime's heartbeat) and
``engine.step`` (the top of each tick of ``TorchEngine._loop``). The other
names of the catalog below are the reference's sites of modules the port
has not taken yet; the registry accepts any name, so tests can add their
own.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from .logging import get_logger

log = get_logger("runtime.faults")

ENV_FAULTS = "DTPU_FAULTS"

# the reference's catalog of fault points (the port wires every one but
# controller.spawn: the deploy controller is not ported)
FAULT_POINTS = (
    "request_plane.send",        # tcp client, before the request goes out
    "request_plane.connect",     # tcp client connection establishment
    "event_plane.publish",       # broker (tcp_plane) + inproc event planes
    "discovery.call",            # netstore KV operations
    "discovery.lease_keepalive", # runtime keepalive heartbeat
    "discovery.watch",           # etcd watch stream (per reconnect attempt)
    "transfer.pull",             # KV transfer client fetch
    "transfer.stream_window",    # streamed fetch, per block window (client)
    "transfer.native_fetch",     # native (C++ agent) bulk fetch
    "engine.step",               # engine step loop (crash/watchdog drills)
    "controller.spawn",          # deploy controller process spawn
    "drain.notice",              # reclaim notice delivery (engine/drain.py)
    "checkpoint.write",          # per sealed-block checkpoint file write
    "checkpoint.manifest",       # atomic manifest commit (pre-rename)
    "restore.read",              # checkpoint manifest/block read on restore
    "directory.publish",         # global KV directory advertisement write
    "directory.lookup",          # global KV directory hash lookup
    "fetch.peer_tier",           # peer G2/G3 tier fetch (client side)
)

ACTIONS = ("fail", "drop", "delay", "hang", "corrupt")


class FaultInjected(RuntimeError):
    """A deliberately injected application-level failure."""

    code = "fault_injected"


class InjectedDrop(ConnectionError):
    """A deliberately injected transport loss (retryable by policy)."""

    code = "fault_drop"


@dataclasses.dataclass
class FaultRule:
    point: str
    action: str
    value: Optional[float] = None   # seconds for delay/hang
    nth: Optional[int] = None       # 1-based call index
    from_nth: bool = False
    prob: Optional[float] = None
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.action in ("delay", "hang") and self.value is None:
            raise ValueError(f"{self.action} needs a value, e.g. delay=0.5")
        if self.seed is not None and self.prob is None:
            self.prob = 0.5
        self._rng = random.Random(self.seed)
        # memoized per-call decisions: fires_at(i) is a pure function of
        # (rule, seed, i) regardless of evaluation order
        self._decisions: List[bool] = []

    def fires_at(self, i: int) -> bool:
        """Does this rule fire on the point's ``i``-th call (1-based)?"""
        if self.nth is not None:
            return i >= self.nth if self.from_nth else i == self.nth
        if self.prob is not None:
            while len(self._decisions) < i:
                self._decisions.append(self._rng.random() < self.prob)
            return self._decisions[i - 1]
        return True


def parse_faults(spec: str) -> List[FaultRule]:
    rules: List[FaultRule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        point, sep, rest = part.partition(":")
        if not sep or not point or not rest:
            raise ValueError(f"bad fault rule {part!r} (want point:action[...])")
        fields = rest.split("@")
        action, vsep, raw_val = fields[0].partition("=")
        value = None
        if vsep:
            try:
                value = float(raw_val)
            except ValueError:
                raise ValueError(f"bad fault value in {part!r}") from None
        nth = None
        from_nth = False
        prob = None
        seed = None
        for q in fields[1:]:
            q = q.strip()
            if q.endswith("+") and q[:-1].isdigit():
                nth, from_nth = int(q[:-1]), True
            elif q.isdigit():
                nth = int(q)
            elif q.startswith("p="):
                prob = float(q[2:])
            elif q.startswith("seed="):
                seed = int(q[5:])
            else:
                raise ValueError(f"bad fault qualifier {q!r} in {part!r}")
        rules.append(FaultRule(
            point=point.strip(), action=action.strip(), value=value,
            nth=nth, from_nth=from_nth, prob=prob, seed=seed,
        ))
    return rules


class FaultRegistry:
    """Armed fault rules + per-point call counters + fired-event log.

    The unarmed fast path is one falsy-dict check, so instrumented hot paths
    cost nothing in production. ``fired`` records ``(point, action, call_n)``
    for every injection — chaos tests assert two runs with the same seeds
    produce identical logs.
    """

    def __init__(self) -> None:
        self._rules: Dict[str, List[FaultRule]] = {}
        self._calls: Dict[str, int] = {}
        self.fired: List[Tuple[str, str, int]] = []
        self._lock = threading.Lock()

    # -- arming --------------------------------------------------------------
    @property
    def armed(self) -> bool:
        return bool(self._rules)

    def arm(self, spec: str) -> None:
        for rule in parse_faults(spec):
            self.arm_rule(rule)

    def arm_rule(self, rule: FaultRule) -> None:
        with self._lock:
            self._rules.setdefault(rule.point, []).append(rule)
        log.warning("fault armed: %s:%s", rule.point, rule.action)

    def disarm(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._rules.clear()
                self._calls.clear()
                self.fired = []
            else:
                self._rules.pop(point, None)
                self._calls.pop(point, None)

    def calls(self, point: str) -> int:
        return self._calls.get(point, 0)

    def plan(self, point: str, n_calls: int) -> List[Tuple[int, str]]:
        """Preview which of the next ``n_calls`` calls would fire, WITHOUT
        consuming the schedule (fresh rule clones are interrogated). Lets
        tests assert determinism against the live ``fired`` log."""
        out: List[Tuple[int, str]] = []
        for rule in self._rules.get(point, ()):  # same arming order
            clone = dataclasses.replace(rule)
            for i in range(1, n_calls + 1):
                if clone.fires_at(i):
                    out.append((i, rule.action))
        out.sort()
        return out

    # -- firing --------------------------------------------------------------
    def _fire(self, point: str, corrupt_pass: bool) -> List[FaultRule]:
        rules = self._rules.get(point)
        if not rules:
            return []
        counter = point + "#corrupt" if corrupt_pass else point
        with self._lock:
            i = self._calls.get(counter, 0) + 1
            self._calls[counter] = i
            hits = [
                r for r in rules
                if (r.action == "corrupt") == corrupt_pass and r.fires_at(i)
            ]
            for r in hits:
                self.fired.append((point, r.action, i))
        for r in hits:
            log.warning("fault fired: %s:%s (call %d)", point, r.action, i)
        return hits

    def _raise_for(self, rule: FaultRule, point: str) -> None:
        if rule.action == "drop":
            raise InjectedDrop(f"injected drop at {point}")
        if rule.action == "fail":
            raise FaultInjected(f"injected failure at {point}")

    def inject(self, point: str) -> None:
        """Sync fault point: delay/hang block the thread; drop/fail raise."""
        if not self._rules:
            return
        for rule in self._fire(point, corrupt_pass=False):
            if rule.action in ("delay", "hang"):
                time.sleep(float(rule.value))
            else:
                self._raise_for(rule, point)

    async def ainject(self, point: str) -> None:
        """Async fault point: delay/hang await; drop/fail raise."""
        if not self._rules:
            return
        for rule in self._fire(point, corrupt_pass=False):
            if rule.action in ("delay", "hang"):
                await asyncio.sleep(float(rule.value))
            else:
                self._raise_for(rule, point)

    def mangle(self, point: str, payload: bytes) -> bytes:
        """Apply armed ``corrupt`` rules to a payload (separate call counter,
        suffix ``#corrupt``, so a site may call inject() AND mangle())."""
        if not self._rules:
            return payload
        for _rule in self._fire(point, corrupt_pass=True):
            if payload:
                payload = bytes([payload[0] ^ 0xFF]) + payload[1:]
        return payload


FAULTS = FaultRegistry()


def reload_from_env() -> None:
    """(Re)arm the process registry from ``DTPU_FAULTS``; tests use this
    after mutating the env. A bad spec logs and leaves the registry clean —
    a typo must not take the worker down before the chaos drill starts."""
    FAULTS.disarm()
    spec = os.environ.get(ENV_FAULTS)
    if not spec:
        return
    try:
        FAULTS.arm(spec)
    except ValueError as e:
        log.error("ignoring bad %s=%r: %s", ENV_FAULTS, spec, e)


reload_from_env()
