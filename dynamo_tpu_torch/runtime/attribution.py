"""Critical-path attribution: where did a request's end-to-end time go?

The port's copy of the reference package's runtime/attribution.py. The
SLO accountant (runtime/slo.py) says *whether* a class is missing its
promise; this module says *why*. Every finished request already leaves
a flight-recorder timeline of milestone events (received, tokenized,
routed, fetch/transfer, queued, admitted, first_token, finish) — the
recorder stamps them, nobody adds timestamps for us. :func:`attribute`
decomposes that timeline into an exhaustive, non-overlapping phase
breakdown that **provably sums to the e2e duration**: the gap between each
consecutive pair of events is charged to exactly one phase (keyed on the
later event's kind, with a lifecycle-position fallback for kinds the table
does not know), and all arithmetic is integer nanoseconds, so

    sum(phases) == last_event_ts - first_event_ts        (exactly)

holds for ANY timeline, including ones with unknown or out-of-order kinds.

Phases (the fixed schema every consumer reads):

- ``frontend_queue``  — HTTP receipt -> tokenized (parse + tokenize)
- ``route``           — routing decisions, dispatch, request-plane hops
- ``kv_fetch``        — peer-tier/disagg KV fetch + tier onboarding
- ``prefill_queue``   — engine admission wait (queued -> admitted)
- ``prefill_compute`` — admitted -> first token
- ``decode``          — first token -> terminal finish/abort
- ``epilogue``        — anything after the terminal event (frontend flush,
  accounting) in merged frontend+worker timelines

Three consumers, one decomposition:

- ``/debug/requests?id=`` gains an ``attribution`` section next to the
  ``slo`` budget breakdown (runtime/flight_recorder.py grafts it);
- ``dtpu_request_phase_seconds{phase,sla_class}`` histograms;
- :class:`AttributionAggregator` keeps rolling per-(model, class)
  "where does p99 go" dominant-phase aggregates on the same
  clock-injectable windowed machinery as the SLO accountant;
  ``/debug/worker`` and ``/debug/fleet`` serve its snapshots.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .logging import get_logger

log = get_logger("attribution")

# the fixed phase schema, in lifecycle order
PHASES: Tuple[str, ...] = (
    "frontend_queue",
    "route",
    "kv_fetch",
    "prefill_queue",
    "prefill_compute",
    "decode",
    "epilogue",
)

# event kind -> phase charged for the gap ENDING at this event. Kinds not
# listed fall back to the lifecycle position (see _fallback_phase): the
# decomposition must stay exhaustive when new kinds appear.
_PHASE_OF_GAP_END: Dict[str, Optional[str]] = {
    "received": None,               # timeline origin
    "tokenized": "frontend_queue",
    "routed": "route",
    "prefill_routed": "route",
    "prefill_streamed": "route",
    "prefill_deflected": "route",
    "global_kv_plan": "route",
    "fetch_started": "route",       # dispatch up to the moment the fetch began
    "fetch_committed": "kv_fetch",
    "fetch_aborted": "kv_fetch",
    "transfer": "kv_fetch",
    "onboard": "kv_fetch",
    "queued": "route",
    "admitted": "prefill_queue",
    "first_token": "prefill_compute",
    "migration": "decode",
    "slo_violation": "decode",
    "finish": "decode",
    "abort": "decode",
}

_TERMINAL_KINDS = ("finish", "abort")


def _fallback_phase(seen: Dict[str, bool]) -> str:
    """Phase for an unknown kind, from the milestones already passed."""
    if seen.get("terminal"):
        return "epilogue"
    if seen.get("first_token"):
        return "decode"
    if seen.get("admitted"):
        return "prefill_compute"
    if seen.get("queued"):
        return "prefill_queue"
    if seen.get("tokenized"):
        return "route"
    return "frontend_queue"


def attribute(flight: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Decompose one flight-recorder timeline into the phase breakdown.

    ``flight`` is the recorder's timeline dict (``events`` is a list of
    ``{"timestamp": unix_ns, "event": {"kind": ...}}``). Returns None for
    timelines with fewer than two events (no duration to attribute).
    All sums are integer ns: ``sum(phases_ns.values()) == e2e_ns`` exactly.
    """
    events = flight.get("events") or []
    if len(events) < 2:
        return None
    ordered = sorted(events, key=lambda e: e["timestamp"])
    phases_ns: Dict[str, int] = {p: 0 for p in PHASES}
    seen: Dict[str, bool] = {}
    prev_ts = ordered[0]["timestamp"]
    _note(seen, ordered[0]["event"].get("kind"))
    for entry in ordered[1:]:
        ts = entry["timestamp"]
        kind = entry["event"].get("kind")
        gap = max(int(ts) - int(prev_ts), 0)
        if seen.get("terminal"):
            phase = "epilogue"
        else:
            phase = _PHASE_OF_GAP_END.get(kind) or _fallback_phase(seen)
        phases_ns[phase] += gap
        _note(seen, kind)
        prev_ts = ts
    e2e_ns = int(ordered[-1]["timestamp"]) - int(ordered[0]["timestamp"])
    dominant = max(PHASES, key=lambda p: (phases_ns[p], -PHASES.index(p)))
    return {
        "e2e_ns": e2e_ns,
        "phases_ns": phases_ns,
        "dominant": dominant,
        "events": len(ordered),
    }


def _note(seen: Dict[str, bool], kind: Optional[str]) -> None:
    if kind in _TERMINAL_KINDS:
        seen["terminal"] = True
    elif kind in ("tokenized", "queued", "admitted", "first_token"):
        seen[kind] = True


def attribution_breakdown(flight: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The ``/debug/requests?id=`` ``attribution`` section: phase seconds +
    shares, human-readable, derived from :func:`attribute`."""
    attr = attribute(flight)
    if attr is None:
        return None
    e2e_ns = attr["e2e_ns"]
    out: Dict[str, Any] = {
        "e2e_s": round(e2e_ns / 1e9, 6),
        "dominant": attr["dominant"],
        "phases": {
            p: round(ns / 1e9, 6) for p, ns in attr["phases_ns"].items()
        },
    }
    if e2e_ns > 0:
        out["shares"] = {
            p: round(ns / e2e_ns, 4) for p, ns in attr["phases_ns"].items()
        }
    return out


# ---------------------------------------------------------------------------
# rolling per-(model, class) aggregates — the "where does p99 go" ledger
# ---------------------------------------------------------------------------

# same windowing constants as the SLO accountant (runtime/slo.py): the two
# ledgers answer "is the promise kept" / "where does the time go" over the
# same horizons
WINDOWS: Dict[str, float] = {"1m": 60.0, "5m": 300.0, "1h": 3600.0}
TOTAL_WINDOW = "total"
_BUCKET_S = 10.0
_RETAIN_S = max(WINDOWS.values())
# per-bucket sample cap: p99 needs the tail samples, not all of them; a
# 10s bucket holding 512 requests bounds memory at fleet rates while the
# count/sum aggregates stay exact
_BUCKET_SAMPLES = 512

_HIST_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                 2.5, 5.0, 15.0, 60.0)


class _Bucket:
    __slots__ = ("count", "e2e_sum_ns", "phase_sums_ns", "samples",
                 "dropped")

    def __init__(self) -> None:
        self.count = 0
        self.e2e_sum_ns = 0
        self.phase_sums_ns = {p: 0 for p in PHASES}
        # (e2e_ns, phases_ns) pairs for tail percentiles
        self.samples: List[Tuple[int, Dict[str, int]]] = []
        self.dropped = 0


class AttributionAggregator:
    """Rolling per-(model, sla_class) phase aggregates on an injectable
    clock — the exact windowed-bucket machinery of ``SloAccountant``.
    Thread-safe: the engine feeds it from executor threads, the status
    servers read it from the event loop."""

    def __init__(
        self,
        clock: Optional[Callable[[], float]] = None,
        metrics=None,
    ):
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        # (model, sla_class) -> {bidx: _Bucket}, plus a cumulative bucket
        self._buckets: Dict[tuple, Dict[int, _Bucket]] = {}
        self._totals: Dict[tuple, _Bucket] = {}
        self._phase_h = None
        if metrics is not None:
            self.bind_metrics(metrics)

    def bind_metrics(self, scope) -> None:
        from . import metrics as M

        self._phase_h = scope.histogram(
            M.REQUEST_PHASE_SECONDS,
            "per-request critical-path phase duration",
            extra_labels=(M.LABEL_MODEL, M.LABEL_SLA_CLASS, "phase"),
            buckets=_HIST_BUCKETS,
        )

    # -- producer side -------------------------------------------------------
    def observe(
        self,
        model: str,
        sla_class: str,
        attr: Dict[str, Any],
    ) -> None:
        """Fold one :func:`attribute` result into the rolling windows (and
        the phase histograms when metrics are bound)."""
        e2e_ns = int(attr["e2e_ns"])
        phases_ns = attr["phases_ns"]
        key = (model, sla_class)
        now = self._clock()
        with self._lock:
            per = self._buckets.setdefault(key, {})
            total = self._totals.setdefault(key, _Bucket())
            bidx = int(now / _BUCKET_S)
            bucket = per.get(bidx)
            if bucket is None:
                bucket = per[bidx] = _Bucket()
                floor = int((now - _RETAIN_S) / _BUCKET_S) - 1
                for old in [b for b in per if b < floor]:
                    del per[old]
            for cell in (bucket, total):
                cell.count += 1
                cell.e2e_sum_ns += e2e_ns
                for p in PHASES:
                    cell.phase_sums_ns[p] += int(phases_ns.get(p, 0))
                if len(cell.samples) < _BUCKET_SAMPLES:
                    cell.samples.append((e2e_ns, dict(phases_ns)))
                else:
                    cell.dropped += 1
        if self._phase_h is not None:
            for p in PHASES:
                ns = int(phases_ns.get(p, 0))
                if ns > 0:
                    self._phase_h.observe(
                        ns / 1e9, model=model, sla_class=sla_class, phase=p
                    )

    def observe_flight(
        self, model: str, sla_class: str, flight: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """Convenience: attribute a timeline and fold it in; returns the
        attribution (None when the timeline was too short to decompose)."""
        attr = attribute(flight)
        if attr is not None:
            self.observe(model, sla_class, attr)
        return attr

    # -- consumer side -------------------------------------------------------
    def _window_cells(self, key: tuple, window: str, now: float) -> List[_Bucket]:
        if window == TOTAL_WINDOW:
            total = self._totals.get(key)
            return [total] if total is not None else []
        span = WINDOWS[window]
        floor = int((now - span) / _BUCKET_S) + 1
        per = self._buckets.get(key, {})
        return [b for bidx, b in per.items() if bidx >= floor]

    def snapshot(self) -> Dict[str, Any]:
        """The ``/debug``-facing payload: per (model, class) per window,
        mean phase shares, the dominant phase of the p99 tail, and the tail
        e2e, rounded."""
        now = self._clock()
        out: Dict[str, Any] = {
            "windows": sorted(WINDOWS) + [TOTAL_WINDOW],
            "phases": list(PHASES),
            "models": {},
        }
        with self._lock:
            keys = sorted(set(self._buckets) | set(self._totals))
            gathered = {
                key: {
                    w: [
                        (c.count, c.e2e_sum_ns, dict(c.phase_sums_ns),
                         list(c.samples), c.dropped)
                        for c in self._window_cells(key, w, now)
                    ]
                    for w in list(WINDOWS) + [TOTAL_WINDOW]
                }
                for key in keys
            }
        for (model, cls), per_window in gathered.items():
            windows_obj = {}
            for w, cells in per_window.items():
                count = sum(c[0] for c in cells)
                if count == 0:
                    windows_obj[w] = {"requests": 0}
                    continue
                e2e_sum = sum(c[1] for c in cells)
                phase_sums = {p: sum(c[2][p] for c in cells) for p in PHASES}
                samples: List[Tuple[int, Dict[str, int]]] = []
                for c in cells:
                    samples.extend(c[3])
                dropped = sum(c[4] for c in cells)
                windows_obj[w] = _window_body(
                    count, e2e_sum, phase_sums, samples, dropped
                )
            out["models"].setdefault(model, {})[cls] = windows_obj
        return out


def _window_body(
    count: int,
    e2e_sum_ns: int,
    phase_sums_ns: Dict[str, int],
    samples: List[Tuple[int, Dict[str, int]]],
    dropped: int,
) -> Dict[str, Any]:
    body: Dict[str, Any] = {
        "requests": count,
        "e2e_mean_s": round(e2e_sum_ns / count / 1e9, 6),
        "mean_share": {
            p: round(ns / e2e_sum_ns, 4) if e2e_sum_ns else 0.0
            for p, ns in phase_sums_ns.items()
        },
    }
    body["dominant"] = max(
        PHASES, key=lambda p: (phase_sums_ns[p], -PHASES.index(p))
    )
    if samples:
        tail = tail_samples(samples)
        tail_e2e = sum(s[0] for s in tail)
        tail_phases = {
            p: sum(int(s[1].get(p, 0)) for s in tail) for p in PHASES
        }
        body["p99"] = {
            "e2e_s": round(min(s[0] for s in tail) / 1e9, 6),
            "dominant": max(
                PHASES, key=lambda p: (tail_phases[p], -PHASES.index(p))
            ),
            "share": {
                p: round(ns / tail_e2e, 4) if tail_e2e else 0.0
                for p, ns in tail_phases.items()
            },
        }
    if dropped:
        body["sampled_out"] = dropped
    return body


def tail_samples(
    samples: List[Tuple[int, Dict[str, int]]], q: float = 0.99
) -> List[Tuple[int, Dict[str, int]]]:
    """The slowest ``ceil((1-q) * n)`` samples by e2e — the requests at and
    beyond the q-th percentile, whose phase sums define "where p99 goes"."""
    n = len(samples)
    k = max(1, n - int(q * n))
    return sorted(samples, key=lambda s: s[0])[-k:]


# ---------------------------------------------------------------------------
# process-global aggregator (like the flight recorder / SLO accountant:
# importable anywhere without wiring)
# ---------------------------------------------------------------------------

_global_aggregator: Optional[AttributionAggregator] = None
_global_lock = threading.Lock()


def get_attribution() -> AttributionAggregator:
    global _global_aggregator
    if _global_aggregator is None:
        with _global_lock:
            if _global_aggregator is None:
                _global_aggregator = AttributionAggregator()
    return _global_aggregator


def set_attribution(agg: Optional[AttributionAggregator]) -> None:
    global _global_aggregator
    _global_aggregator = agg
