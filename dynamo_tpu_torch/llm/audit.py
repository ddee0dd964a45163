"""Request/response audit subsystem for the OpenAI frontends.

The port's copy of the reference package's llm/audit.py: a policy decides
per-request whether to audit (enabled via ``DTPU_AUDIT_SINKS``; honored
when the request sets ``store`` or ``DTPU_AUDIT_FORCE_LOGGING`` is on), a
handle accumulates the request and final response, and ``emit()``
publishes one AuditRecord to every configured sink exactly once. Sinks:
``stderr`` (structured log line), ``jsonl:<path>`` (file), ``event`` (the
runtime event plane, records packed by the port's codec).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, List, Optional

from ..runtime.logging import get_logger

log = get_logger("llm.audit")

AUDIT_SCHEMA_VERSION = 1


@dataclasses.dataclass
class AuditPolicy:
    enabled: bool = False
    force_logging: bool = False
    sinks: List[str] = dataclasses.field(default_factory=list)

    @classmethod
    def from_env(cls) -> "AuditPolicy":
        from ..runtime.config import (
            ENV_AUDIT_FORCE_LOGGING,
            ENV_AUDIT_SINKS,
            is_truthy,
        )

        sinks_env = (
            os.environ.get(ENV_AUDIT_SINKS) or os.environ.get("DYN_AUDIT_SINKS", "")
        )
        sinks = [s.strip() for s in sinks_env.split(",") if s.strip()]
        return cls(
            enabled=bool(sinks),
            force_logging=is_truthy(
                os.environ.get(ENV_AUDIT_FORCE_LOGGING)
                or os.environ.get("DYN_AUDIT_FORCE_LOGGING")
            ),
            sinks=sinks,
        )


@dataclasses.dataclass
class AuditRecord:
    schema_version: int
    request_id: str
    requested_streaming: bool
    model: str
    request: Optional[Dict[str, Any]] = None
    response: Optional[Dict[str, Any]] = None

    def to_obj(self) -> Dict[str, Any]:
        obj = {
            "schema_version": self.schema_version,
            "request_id": self.request_id,
            "requested_streaming": self.requested_streaming,
            "model": self.model,
        }
        if self.request is not None:
            obj["request"] = self.request
        if self.response is not None:
            obj["response"] = self.response
        return obj


class StderrSink:
    name = "stderr"

    def emit(self, rec: AuditRecord) -> None:
        log.info("audit %s", json.dumps(rec.to_obj()))


class JsonlSink:
    name = "jsonl"

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def emit(self, rec: AuditRecord) -> None:
        with self._lock, open(self.path, "a") as f:
            f.write(json.dumps(rec.to_obj()) + "\n")


class EventPlaneSink:
    """Publish records on the runtime event plane; subject from
    DTPU_AUDIT_SUBJECT."""

    name = "event"

    def __init__(self, event_plane, subject: Optional[str] = None):
        from ..runtime.config import ENV_AUDIT_SUBJECT

        self.event_plane = event_plane
        self.subject = subject or os.environ.get(
            ENV_AUDIT_SUBJECT, os.environ.get("DYN_AUDIT_SUBJECT", "dynamo.audit.v1")
        )
        self._pending: List[AuditRecord] = []

    def emit(self, rec: AuditRecord) -> None:
        # event planes are async; buffer for the bus pump (AuditBus.drain)
        self._pending.append(rec)

    async def drain(self) -> None:
        from ..runtime import codec

        pending, self._pending = self._pending, []
        for rec in pending:
            await self.event_plane.publish(self.subject, codec.packb(rec.to_obj()))


class AuditBus:
    """Fan records out to every sink: synchronous fan-out plus an async
    drain for the event-plane sink."""

    def __init__(self, policy: Optional[AuditPolicy] = None, event_plane=None):
        self.policy = policy or AuditPolicy.from_env()
        self.sinks: List[Any] = []
        for spec in self.policy.sinks:
            if spec == "stderr":
                self.sinks.append(StderrSink())
            elif spec.startswith("jsonl:"):
                self.sinks.append(JsonlSink(spec.split(":", 1)[1]))
            elif spec == "event":
                if event_plane is not None:
                    self.sinks.append(EventPlaneSink(event_plane))
                else:
                    log.warning("audit sink 'event' requested but no event plane wired")
            else:
                log.warning("unknown audit sink %r ignored", spec)

    def publish(self, rec: AuditRecord) -> None:
        for sink in self.sinks:
            try:
                sink.emit(rec)
            except Exception:
                log.exception("audit sink %s failed", getattr(sink, "name", "?"))

    async def drain_async_sinks(self) -> None:
        for sink in self.sinks:
            drain = getattr(sink, "drain", None)
            if drain is not None:
                try:
                    await drain()
                except Exception:
                    log.exception("audit sink %s drain failed", getattr(sink, "name", "?"))

    # -- handle creation ------------------------------------------------------
    def create_handle(
        self, request_obj: Dict[str, Any], request_id: str, model: str,
        streaming: bool,
    ) -> Optional["AuditHandle"]:
        """None unless policy says this request is audited: enabled and
        (the request's ``store`` flag or force_logging)."""
        if not self.policy.enabled or not self.sinks:
            return None
        if not self.policy.force_logging and not request_obj.get("store"):
            return None
        return AuditHandle(
            bus=self,
            request_id=request_id,
            model=model,
            requested_streaming=streaming,
            request=request_obj,
        )


@dataclasses.dataclass
class AuditHandle:
    bus: AuditBus
    request_id: str
    model: str
    requested_streaming: bool
    request: Optional[Dict[str, Any]] = None
    response: Optional[Dict[str, Any]] = None
    _emitted: bool = False

    def set_response(self, response_obj: Dict[str, Any]) -> None:
        self.response = response_obj

    def emit(self) -> None:
        if self._emitted:
            return
        self._emitted = True
        self.bus.publish(AuditRecord(
            schema_version=AUDIT_SCHEMA_VERSION,
            request_id=self.request_id,
            requested_streaming=self.requested_streaming,
            model=self.model,
            request=self.request,
            response=self.response,
        ))
