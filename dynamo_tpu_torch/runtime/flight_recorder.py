"""Request flight recorder: bounded in-memory ring of per-request timelines.

The port's copy of the reference package's runtime/flight_recorder.py.

Every request leaves a timeline of milestone events (received, tokenized,
routed, queued, admitted, prefill start/end, first token, migration, KV
transfer, finish/abort) in a fixed-capacity ring, so "what happened to
request X" is answerable after the fact without tracing infrastructure.
Exposed as ``/debug/requests`` on the component status servers
(runtime/health.py StatusServer, llm/http frontend).

Events use ``runtime/recorder.py``'s JSONL event model — each entry is
``{"timestamp": <unix_ns>, "event": {...}}`` — so a failure dump
(``DTPU_FLIGHT_DUMP``) is directly loadable with ``Recorder.load()`` and
replayable with ``Recorder.replay()``.

The recorder is always on: it is a few dicts and a lock, no I/O on the
record path (the failure dump writes on the abort path only). Producers on
any thread are fine — the engine stamps events from its executor threads.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, Optional

from .config import ENV_FLIGHT_CAPACITY, ENV_FLIGHT_DUMP, env_int, env_str
from .logging import get_logger

log = get_logger("flight_recorder")

DEFAULT_CAPACITY = 512
# per-request event cap: a pathological stream (one migration per token) must
# not grow a single timeline without bound; the tail event notes the drop
MAX_EVENTS_PER_REQUEST = 64


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 dump_path: Optional[str] = None):
        self.capacity = max(1, capacity)
        self.dump_path = dump_path
        self._lock = threading.Lock()
        # request_id -> flight; insertion-ordered so eviction drops the
        # oldest request wholesale (a ring of timelines, not of events)
        self._flights: "collections.OrderedDict[str, Dict[str, Any]]" = (
            collections.OrderedDict()
        )

    # -- producer side --------------------------------------------------------
    def record(self, request_id: Optional[str], kind: str,
               _terminal: bool = False, **fields: Any) -> None:
        """Append one milestone event to the request's timeline."""
        if not request_id:
            return
        entry = {
            "timestamp": time.time_ns(),
            "event": {"kind": kind, **fields},
        }
        with self._lock:
            flight = self._flights.get(request_id)
            if flight is None:
                flight = self._flights[request_id] = {
                    "request_id": request_id,
                    "started_ns": entry["timestamp"],
                    "done": False,
                    "error": None,
                    "events": [],
                    "dropped_events": 0,
                }
                while len(self._flights) > self.capacity:
                    self._flights.popitem(last=False)
            # the cap bounds runaway mid-flight streams only: the terminal
            # finish/abort event (error class, status) must always land —
            # it is the record a failure dump exists to preserve
            if not _terminal and len(flight["events"]) >= MAX_EVENTS_PER_REQUEST:
                flight["dropped_events"] += 1
                return
            flight["events"].append(entry)

    def finish(self, request_id: Optional[str], error: Optional[str] = None,
               error_class: Optional[str] = None, **fields: Any) -> None:
        """Close the request's timeline; an ``error`` marks it failed and
        dumps the full timeline (log + optional JSONL file)."""
        if not request_id:
            return
        kind = "abort" if error else "finish"
        if error:
            fields["error"] = str(error)[:500]
            fields["error_class"] = error_class or "internal"
        self.record(request_id, kind, _terminal=True, **fields)
        with self._lock:
            flight = self._flights.get(request_id)
            if flight is None:
                return
            flight["done"] = True
            if error:
                flight["error"] = str(error)[:500]
            dump = dict(flight, events=list(flight["events"])) if error else None
        if dump is not None:
            self._dump_failure(dump)

    # -- consumer side --------------------------------------------------------
    def timeline(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            flight = self._flights.get(request_id)
            return None if flight is None else dict(
                flight, events=list(flight["events"])
            )

    def snapshot(self, limit: int = 64) -> Dict[str, Any]:
        """The ``/debug/requests`` payload: most-recent-first timelines."""
        with self._lock:
            # limit<=0 means none: [-0:] would be the WHOLE ring
            recent = list(self._flights.values())[-limit:] if limit > 0 else []
            recent = [dict(f, events=list(f["events"])) for f in recent]
        recent.reverse()
        return {
            "capacity": self.capacity,
            "retained": len(self._flights),
            "requests": recent,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._flights)

    # -- failure dump ---------------------------------------------------------
    def _dump_failure(self, flight: Dict[str, Any]) -> None:
        log.warning(
            "request %s failed: %s; timeline: %s",
            flight["request_id"][:16], flight["error"],
            json.dumps([e["event"] for e in flight["events"]]),
        )
        if not self.dump_path:
            return
        try:
            with open(self.dump_path, "a") as f:
                for entry in flight["events"]:
                    line = dict(entry)
                    line["event"] = dict(
                        line["event"], request_id=flight["request_id"]
                    )
                    f.write(json.dumps(line) + "\n")
        except OSError:
            log.exception("flight-recorder failure dump to %s failed",
                          self.dump_path)


def debug_requests_payload(
    recorder: "FlightRecorder",
    request_id: Optional[str],
    limit_raw: Optional[str],
) -> tuple:
    """(http_status, json payload) for a ``/debug/requests`` query — the ONE
    implementation both the worker StatusServer and the HTTP frontend serve
    (same ?id= lookup, 404 wording, and limit parsing)."""
    if request_id:
        flight = recorder.timeline(request_id)
        if flight is None:
            return 404, {
                "error": f"request {request_id!r} not in the flight recorder"
            }
        # single-request view gains the SLO budget breakdown (queue/prefill/
        # decode share of the TTFT target, remaining deadline) when the
        # engine stamped the request's sla class onto its queued event
        from .attribution import attribution_breakdown
        from .slo import budget_breakdown

        slo = budget_breakdown(flight)
        if slo is not None:
            flight = dict(flight, slo=slo)
        # the critical-path phase decomposition (runtime/attribution.py):
        # exhaustive, non-overlapping, sums to the e2e duration — present
        # for any flight with >= 2 events, classed or not
        attribution = attribution_breakdown(flight)
        if attribution is not None:
            flight = dict(flight, attribution=attribution)
        return 200, flight
    try:
        limit = int(limit_raw) if limit_raw is not None else 64
    except ValueError:
        limit = 64
    return 200, recorder.snapshot(limit=limit)


_global_recorder: Optional[FlightRecorder] = None
_global_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    global _global_recorder
    if _global_recorder is None:
        with _global_lock:
            if _global_recorder is None:
                _global_recorder = FlightRecorder(
                    capacity=env_int(ENV_FLIGHT_CAPACITY, DEFAULT_CAPACITY),
                    dump_path=env_str(ENV_FLIGHT_DUMP, "") or None,
                )
    return _global_recorder


def set_flight_recorder(recorder: Optional[FlightRecorder]) -> None:
    global _global_recorder
    _global_recorder = recorder
