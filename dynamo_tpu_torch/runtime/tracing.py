"""Distributed tracing: W3C traceparent propagation + OTLP-shaped export.

The port's copy of the reference package's runtime/tracing.py, on the
standard library. Spans are plain host-side bookkeeping (never recorded
inside a CUDA graph capture); propagation rides the channels the reference
uses: HTTP headers in the frontend, request annotations on the request
plane.

Exporters:
- ``JsonlExporter``    OTLP-shaped span dicts to a JSONL file
                       (``DTPU_TRACE_JSONL``; collectors can tail it).
- ``OtlpHttpExporter`` OTLP/HTTP JSON to a configured collector endpoint
                       (``DTPU_OTLP_ENDPOINT``), one POST per batch from a
                       thread of its own, best-effort.
- ``InMemoryExporter`` tests.

Span context propagates across ``asyncio`` tasks via ``contextvars``, so an
engine's nested spans parent correctly without explicit plumbing.
"""

from __future__ import annotations

import atexit
import contextvars
import dataclasses
import json
import os
import queue
import secrets
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .logging import get_logger

log = get_logger("tracing")

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "dtpu_torch_current_span", default=None
)

TRACEPARENT_VERSION = "00"
SAMPLED_FLAG = "01"


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return secrets.token_hex(8)


def parse_traceparent(header: str) -> Tuple[Optional[str], Optional[str]]:
    """``00-<trace_id>-<parent_span_id>-<flags>`` -> (trace_id, parent_id).

    Malformed headers yield (None, None): a bad client header must never
    fail a request."""
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None, None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None, None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None, None
    return trace_id.lower(), span_id.lower()


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"{TRACEPARENT_VERSION}-{trace_id}-{span_id}-{SAMPLED_FLAG}"


@dataclasses.dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    start_ns: int = 0
    end_ns: int = 0
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    status: str = "OK"
    _tracer: Optional["Tracer"] = dataclasses.field(default=None, repr=False)
    _token: Any = dataclasses.field(default=None, repr=False)

    def set(self, **attrs: Any) -> "Span":
        self.attributes.update(attrs)
        return self

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    # -- context manager ------------------------------------------------------
    def __enter__(self) -> "Span":
        self.start_ns = time.time_ns()
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end_ns = time.time_ns()
        if exc_type is not None:
            self.status = "ERROR"
            self.attributes.setdefault("exception", repr(exc))
        if self._token is not None:
            try:
                _current_span.reset(self._token)
            except ValueError:
                # async generators may exit in a different Context than the
                # one that entered the span; the var is task-local anyway
                pass
        if self._tracer is not None:
            self._tracer._finish(self)

    def to_otlp(self) -> Dict[str, Any]:
        """One span in OTLP/JSON shape (the unit inside scopeSpans.spans)."""
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            **({"parentSpanId": self.parent_id} if self.parent_id else {}),
            "name": self.name,
            "kind": 1,
            "startTimeUnixNano": str(self.start_ns),
            "endTimeUnixNano": str(self.end_ns),
            "attributes": [
                {"key": k, "value": _otlp_value(v)}
                for k, v in self.attributes.items()
            ],
            "status": {"code": 2 if self.status == "ERROR" else 1},
        }


def _otlp_value(v: Any) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def current_span() -> Optional[Span]:
    return _current_span.get()


def current_traceparent() -> Optional[str]:
    sp = _current_span.get()
    return sp.traceparent() if sp is not None else None


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


class InMemoryExporter:
    def __init__(self):
        self.spans: List[Span] = []

    def export(self, spans: List[Span]) -> None:
        self.spans.extend(spans)


class JsonlExporter:
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def export(self, spans: List[Span]) -> None:
        with self._lock, open(self.path, "a") as f:
            for sp in spans:
                f.write(json.dumps(sp.to_otlp()) + "\n")


class OtlpHttpExporter:
    """OTLP/HTTP JSON POST to ``<endpoint>/v1/traces``; best-effort, never
    raises into the request path.

    The POST runs on a dedicated daemon thread behind a bounded queue:
    ``export()`` only enqueues, so a slow/unreachable collector costs the
    caller nothing (it used to block the finishing span's thread for up to
    ``timeout_s``). When the queue is full the batch is dropped, counted in
    ``dropped_spans``. ``flush()`` waits for queued batches to drain —
    registered via ``atexit`` so a short-lived process's tail batch still
    ships without any further span triggering a time-based flush."""

    def __init__(self, endpoint: str, service_name: str = "dynamo_tpu_torch",
                 timeout_s: float = 2.0, queue_max: int = 64):
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.timeout_s = timeout_s
        self.dropped_spans = 0
        self._q: "queue.Queue[Optional[List[Span]]]" = queue.Queue(maxsize=queue_max)
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        atexit.register(self.flush)

    def _ensure_worker(self) -> None:
        with self._worker_lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._run, name="dtpu-otlp-export", daemon=True
                )
                self._worker.start()

    def _run(self) -> None:
        while True:
            batch = self._q.get()
            try:
                if batch:
                    self._post(batch)
            finally:
                self._q.task_done()

    def export(self, spans: List[Span]) -> None:
        self._ensure_worker()
        try:
            self._q.put_nowait(list(spans))
        except queue.Full:
            self.dropped_spans += len(spans)
            log.debug(
                "otlp export queue full (dropping %d spans, %d lifetime)",
                len(spans), self.dropped_spans,
            )

    def flush(self, timeout_s: Optional[float] = None) -> None:
        """Block until queued batches are posted (bounded by ``timeout_s``)."""
        deadline = time.monotonic() + (
            self.timeout_s if timeout_s is None else timeout_s
        )
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._q.all_tasks_done.wait(remaining)

    def _post(self, spans: List[Span]) -> None:
        body = json.dumps({
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": self.service_name},
                }]},
                "scopeSpans": [{
                    "scope": {"name": "dynamo_tpu_torch.tracing"},
                    "spans": [sp.to_otlp() for sp in spans],
                }],
            }]
        }).encode()
        try:
            import urllib.request

            req = urllib.request.Request(
                self.endpoint + "/v1/traces", data=body,
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=self.timeout_s).read()
        except Exception as e:
            log.debug("otlp export failed (dropping %d spans): %r", len(spans), e)


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


class Tracer:
    """Creates spans, batches finished ones, hands them to the exporter.

    Flushing is size/time-triggered on the caller's thread (no background
    task to leak); ``flush()`` forces the rest out — call it on shutdown."""

    def __init__(self, exporter=None, service_name: str = "dynamo_tpu_torch",
                 batch_size: int = 64, flush_interval_s: float = 5.0):
        self.exporter = exporter
        self.service_name = service_name
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self._buf: List[Span] = []
        self._lock = threading.Lock()
        self._last_flush = time.monotonic()

    @classmethod
    def from_env(cls, service_name: str = "dynamo_tpu_torch") -> "Tracer":
        """DTPU_OTLP_ENDPOINT -> OTLP/HTTP; DTPU_TRACE_JSONL -> file; else
        tracing is a no-op (spans still propagate context). The DYN_-prefixed
        spellings are accepted as aliases (the reference's catalog prefix)."""
        from .config import ENV_OTLP_ENDPOINT, ENV_TRACE_JSONL

        endpoint = (
            os.environ.get(ENV_OTLP_ENDPOINT) or os.environ.get("DYN_OTLP_ENDPOINT", "")
        )
        jsonl = (
            os.environ.get(ENV_TRACE_JSONL) or os.environ.get("DYN_TRACE_JSONL", "")
        )
        if endpoint:
            return cls(OtlpHttpExporter(endpoint, service_name), service_name)
        if jsonl:
            return cls(JsonlExporter(jsonl), service_name)
        return cls(None, service_name)

    @property
    def enabled(self) -> bool:
        return self.exporter is not None

    def span(
        self,
        name: str,
        traceparent: Optional[str] = None,
        **attrs: Any,
    ) -> Span:
        """New span. Parenting precedence: explicit ``traceparent`` header >
        ambient contextvar > fresh trace root."""
        trace_id = parent_id = None
        if traceparent:
            trace_id, parent_id = parse_traceparent(traceparent)
        if trace_id is None:
            amb = _current_span.get()
            if amb is not None:
                trace_id, parent_id = amb.trace_id, amb.span_id
        return Span(
            name=name,
            trace_id=trace_id or new_trace_id(),
            span_id=new_span_id(),
            parent_id=parent_id,
            attributes=dict(attrs),
            _tracer=self,
        )

    def emit(
        self,
        name: str,
        start_ns: int,
        end_ns: int,
        traceparent: Optional[str] = None,
        status: str = "OK",
        **attrs: Any,
    ) -> Span:
        """A finished span with explicit timestamps. Engine-loop milestones
        (queue/prefill/decode phases) are observed after the fact from
        per-request timestamps, not wrapped in a context manager — this is
        the export path for those. Does not touch the ambient contextvar."""
        trace_id = parent_id = None
        if traceparent:
            trace_id, parent_id = parse_traceparent(traceparent)
        if trace_id is None:
            amb = _current_span.get()
            if amb is not None:
                trace_id, parent_id = amb.trace_id, amb.span_id
        span = Span(
            name=name,
            trace_id=trace_id or new_trace_id(),
            span_id=new_span_id(),
            parent_id=parent_id,
            start_ns=start_ns,
            end_ns=end_ns,
            attributes=dict(attrs),
            status=status,
        )
        self._finish(span)
        return span

    def _finish(self, span: Span) -> None:
        if self.exporter is None:
            return
        flush_now = False
        with self._lock:
            self._buf.append(span)
            if (
                len(self._buf) >= self.batch_size
                or time.monotonic() - self._last_flush > self.flush_interval_s
            ):
                flush_now = True
        if flush_now:
            self.flush()

    def flush(self) -> None:
        """Hand the buffered batch to the exporter. Non-blocking (the OTLP
        exporter enqueues to its worker thread) — safe on the request path."""
        with self._lock:
            batch, self._buf = self._buf, []
            self._last_flush = time.monotonic()
        if batch and self.exporter is not None:
            self.exporter.export(batch)

    def shutdown(self) -> None:
        """flush() plus a bounded wait for the exporter's queue to drain —
        the process-exit path (a plain flush would enqueue the tail batch
        and then let the daemon thread die with it unsent)."""
        self.flush()
        drain = getattr(self.exporter, "flush", None)
        if drain is not None:
            drain()


_global_tracer: Optional[Tracer] = None


def get_tracer() -> Tracer:
    global _global_tracer
    if _global_tracer is None:
        _global_tracer = Tracer.from_env()
        if _global_tracer.enabled:
            # the tail batch of a short-lived process (worker smoke run,
            # bench) must not die in the buffer; atexit LIFO runs this
            # before the exporter's own queue-drain hook
            atexit.register(_global_tracer.shutdown)
    return _global_tracer


def set_tracer(tracer: Optional[Tracer]) -> None:
    global _global_tracer
    _global_tracer = tracer
